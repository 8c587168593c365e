#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lua_mapreduce_tpu_torch``) on
one NVIDIA card.

    python3 chip_smoke.py

Phases, each a hard failure on any mismatch:

1. build   — compile every CUDA kernel from ``ops/csrc`` with nvcc
             (sm_90a), one process per source, all started together;
2. kernels — each kernel against its plain PyTorch version on the card,
             at the shapes the main paths give it, with the time of the
             kernel, the plain version, one library call (yardstick
             only) and the H100 bound for the same work; bf16 and
             int8 serving rows are also held normwise, and each
             attention row shows its check refuses a wrong output; the
             softmax rows (the wide step's, a vocab-wide (1024, 32768)
             row) and the conv paths' pool calls (the stem's at its real
             (32, 114, 114, 64) input; max rows held at zero error)
             each name the branch of their kernel they took (asserted:
             the main path's wide rows take the 16-byte branches) and
             are held bit-equal over two calls; every product of the
             conv steps (forward, dA, dB), each
             conv also timed once through cuDNN as its yardstick; every
             matmul and q8 row names the K split its kernel picks, every
             flash row (forward, and the backward's dq and dkv) the
             kernel it took (the main paths' bf16 rows must take the
             TMA + wgmma kernels; one forward row at the prefill shape
             and one backward row at the LM training shape drive the
             general kernels through misaligned views), every decode
             row its split count, held bit-for-bit
             equal over two calls, with decode's combine held alone
             against its plain version; the
             conv products are held bit-for-bit equal over two calls, and
             each conv configuration's products are summed over one step
             (kernel against ``torch.matmul``); every q8 decode row (the
             GEMV, M <= 8) names its plan (strip width, cluster split,
             CTAs), is held bit-equal over two calls and is also timed
             cold, its weight and torch.matmul's rotated over 100 MiB of
             copies so that each call reads them from HBM;
3. grads   — autograd through the kernels against autograd through the
             plain versions: the digits MLP and LeNet-5, f32 and bf16;
4. digits  — the six-function MapReduce DP-SGD trainer (256-128-10,
             4 shards × 128, a few loop iterations) through the port's
             LocalExecutor on ``mem:``, held against the same run on the
             CPU;
5. wide    — the single-device trainer on a (8192,)×4 bf16 MLP at batch
             8192, a few steps, each a replay of the captured CUDA graph
             of the step: images/s and model TFLOP/s, beside an eager
             loop written here from the same loss and a fresh SGD (ms
             and peak memory of both; losses and parameters bit-equal);
6. serving — the LM serving path at the full width of the repo's decode
             benchmark (d_model 1024, 16 heads, 8 layers, d_ff 4096,
             vocab 32768; batch 4, prompt 3968, 128 new tokens), random
             weights from a seed: ``greedy_decode(use_prefill=True)`` in
             bf16, then with int8 weights (``quantize_lm``) and an int8
             KV cache, its decode steps replays of one captured step —
             prefill ms, the step's capture ms, decode-tail and
             end-to-end tokens/s, beside the same loop run eagerly
             (same tokens), and from a profiled repeat the kernel time
             and the kernel launches per decode step (each decode call
             is a split kernel and, with more than one split, a
             combine; each q8 call one launch, the GEMV's ms and
             launches a step given apart); the port kernels the profiled
             repeat lists must
             equal the launches credited per replay (a trace that lost
             records is taken again, at most three times);
7. serving check — the same widths at 2 layers in f32 (prompt 256, 32
             new tokens): greedy tokens on the card equal the CPU run
             through the plain versions, prefill equals the position
             scan on the card; a sampled row (temperature 0.8, top_k
             40, a fixed key): captured tokens equal the eager loop's,
             each in the top 40 of its step's logits, top_k=1 is
             greedy; the int8 dict's prefill logits agree with the
             CPU's, and its greedy run with an int8 KV cache is held
             step by step on the head's logits (read from an eager run
             on the card, whose tokens equal the captured run's);
8. conv    — the single-device trainer at the repo's conv benchmarks'
             full width (``benchmarks/kernel_bench.py`` configs
             lenet5_cifar b1024 and resnet18_imagenet b32, 224x224,
             1000 classes), bf16, random weights and inputs from a seed:
             captured ms/step beside the eager loop's (losses and
             parameters bit-equal), images/s, model TFLOP/s, peak memory
             of both, and
             from a profiled repeat where a step's device time goes
             (the matmul kernels' launches per step, the split-K
             reduce's among them);
9. conv check — LeNet-5 b64 and the ResNet-18 ImageNet topology at
             64x64 b4, f32, three trainer steps on the card against the
             same steps on the CPU (LeNet free-running, ResNet from the
             CPU run's parameters at each step): losses within 1e-4
             relative, gradients and parameter updates normwise within
             each model's limits, overall and in the worst parameter
             (ResNet's wider for ReLU kinks, see CONV_CHECKS);
10. lm train — ``make_train_step`` at the full width of the repo's LM
             training benchmark (``bench_transformer_step``: d_model 1024,
             16 heads, 8 layers, d_ff 4096, vocab 32768, seq 2048, batch
             8, bf16, SGD with momentum, ring attention on one device),
             MHA and its llama-style GQA 4:1 form: ms/step, tokens/s,
             model TFLOP/s, peak memory, and from a profiled repeat a
             step's device time by kernel; phase 2 holds the dq and dkv
             backward kernels against the plain backward at its shapes;
11. lm train check — the same widths at 2 layers in f32 (seq 256, batch
             2): three free-running steps on the card against the CPU
             (losses within 1e-4 relative, gradients and parameter
             updates normwise within 1e-4), and a remat + grad_accum=2
             step equal to the plain step;
12. train_lm — the port's trainer script at the LM widths with ``--bf16``
             for 20 steps on its synthetic task: the loss falls;
13. digits e2e — ``examples/digits/e2e.py``: the digits sheet through the
             captured harness and the MapReduce loop, both at least 0.95
             validation accuracy and within 0.05 of each other;
14. resume — ``fit(conf=)`` with a file-backed persistent table: 3
             epochs, then a fresh trainer resumes to 5 (epochs [4, 5],
             parameters equal to a never-stopped run's);
15. kmeans — ``kmeans_fit`` over a world-size-1 NCCL mesh at SIFT1M's
             shape (1,000,000 × 128 f32 synthetic blobs from the seed,
             k = 1024, 20 Lloyd iterations): the iteration captured with
             its all-reduces and replayed, against the same loop run
             eagerly (bit for bit), ms/iteration, idle share, peak
             memory and the inertia history; the fit's first two
             iterations held to a float64 CPU reference at full size
             (every assignment that differs lies within f32 rounding of
             a tie; the updated centroids within 1e-4, history[0..1]
             rtol 1e-3); at 65,536 × 128, k = 64 the card equals the
             CPU within 1e-4;
16. als    — ``als_fit`` over the mesh at MovieLens-1M's shape (6,040 ×
             3,706, 4.47% observed, a low-rank-plus-noise matrix from the
             seed, rank 64, reg 0.1, 10 rounds): captured against eager
             (bit for bit), ms/round, the RMSE history; at 600 × 300 the
             card equals the CPU within 1e-4;
17. dp     — the trainer over the mesh, replicated and ZeRO-1, on the
             digits MLP (b128 f32) and LeNet-5 b1024 bf16: captured steps
             with the collectives inside equal the no-mesh trainer's
             losses, parameters and momentum bit for bit; ms/step of each;
18. executor — ``TpuExecutor`` on the card: ``run_keyed`` of the digits
             gradient, ``run_bucketed`` of a 16-partition histogram and
             ``run_loop`` with an all-reduce inside, each against the CPU;
19. ingraph — the six-function examples under ``engine="ingraph"`` (the
             hard mode: a lowering failure raises), each iteration a
             replay of one capture: ``mr_sgd`` at the flagship width
             (256-128-10, 4 shards × 128, 20 iterations; the collective
             tier, one build) against the store plane on the card and
             the CPU in-graph run (rtol 1e-4, atol 1e-5); ``mr_kmeans``
             at SIFT1M's shape (k = 1024, 8 shards, 3 iterations) against
             the store plane (rtol 1e-4) and ``kmeans_fit`` from the same
             start (assignments differ only at near ties; first updates
             within 1e-4 of their float64 means); ``mr_als`` at
             MovieLens-100K's shape (rank 32, 5 rounds) against
             ``als_fit`` (item factors normwise 1e-4, max abs 2e-3);
             ms/iteration of both engines, peak memory;
20. hybrid, cache — a forced-hybrid int-sum task of wordcount's shape,
             both legs compiled, byte-identical to the store plane; then
             ``kmeans_fit`` at phase 15's shape called twice: one capture
             across both (``graphs.scan``'s cache), equal to each other
             and to the eager loop bit for bit; the second call's
             ms/iteration beside the eager loop's;
21. pool   — the distributed Server and Worker: phase 4's digits task
             (6 iterations, ``shared:`` stores) through ``Server`` over a
             ``FileJobStore`` and two ``cli.execute_worker`` processes —
             result files, ``model.ckpt`` and ``model.meta`` byte-equal to
             a LocalExecutor run on the card, launches summed over the
             processes (each worker's ``--report``) equal to the code's;
             ms/iteration of both (the first apart), the workers' boot and
             task-load seconds, claim and commit rounds, the poll knobs
             beside them; word count (BASELINE config 1) through the
             example's ``execute_example_server.sh --inline-workers 2``,
             equal to a naive count; ``Server(engine="ingraph")`` running
             ``mr_sgd`` (20 iterations, no job inserted), its parameters
             bit-equal to phase 19's LocalExecutor run.
22. moe    — mixture of experts and the (dp, sp) step: the
             ``transformer_step_moe8`` configuration (the LM widths, 8
             experts, top-1, capacity 4096) trained through
             ``make_train_step(mesh=)`` over a dp = sp = 1 NCCL mesh,
             bf16, ring attention: ms/step, tokens/s, the expert
             products' TFLOP/s and a profiled step's device ms by
             kernel; MoE serving at the serving cell's widths (8
             experts), bf16 and int8 + int8 KV: prefill ms, captured
             decode ms/step, launches; then f32 at 2 layers, card
             against the CPU: MoE step losses and gradients, MoE greedy
             tokens, the mesh step bit-equal to the no-mesh step (ring),
             zigzag and Ulysses within 2e-4, ZeRO-1 within 1e-4.
23. tp/pp  — the tensor- and pipeline-parallel steps at the lm_train MHA
             widths (bf16, SGD(1e-3, momentum 0.9)): the 2-D step over
             phase 22's mesh (the yardstick), ``make_train_step_3d``
             over a (dp, sp, mp) = (1, 1, 1) NCCL mesh from
             ``make_multihost_mesh`` (ring attention), and
             ``make_train_step_pp`` over a (pp,) = (1,) mesh in 4
             microbatches on batches a ``make_sharded`` layout in a
             ``shared:`` store yields: ms/step against phase 10's and
             the 2-D one, tokens/s, peak GiB, a profiled step's device
             ms by kind, the kernel path and form of every attention
             call (TMA kernels, the forward's lse form, asserted); then
             f32 at 2 layers, the 3-D and pp steps on the card against
             the no-mesh step on the CPU, and on the card the 3-D step
             against the 2-D mesh step and pp against no mesh within
             1e-5 (loss) / 2e-4 (parameters).
24. data plane — the host plane's object store, v2 segments, retry and
             fault-injection layers, lmr-trace and pipelined shuffle:
             (a) phase 21's digits task through ``Server(FileJobStore,
             pipeline=True, premerge_min_runs=2, segment_format="v2")``
             and two ``execute_worker --trace`` processes on ``object:``
             spill, every process under one seeded ``LMR_FAULT_PLAN``
             (transient, torn, error-after-write and coord-RPC faults):
             ``result.P*``, ``model.ckpt`` and ``model.meta`` byte-equal
             to phase 21's LocalExecutor run, launches summed over the
             processes equal to the code's, the faults the plans fired
             equal to the ``faults_injected`` counted, retries taken,
             every committed job of every iteration with an unbroken
             claim → body → commit span chain; ms/iteration beside phase
             21's; (b) word count at Europarl v7's shape (Zipf text
             from the seed; files cut from 197 to WC_FILES_PY = 48 and
             lines from 10,000 to WC_LINES = 250; printed) through ``cli.execute_server --pipeline
             --segment-format v2 --trace --inline-workers 4`` on
             ``object:`` with the example's 15-way partitioner: counts
             equal to a naive count, result bytes equal to a barrier v1
             LocalExecutor run, the pre-merge overlap from the spans
             and the Chrome trace under ``build/`` (``python -m
             lua_mapreduce_tpu_torch.trace --export``); (c) one
             iteration of (a) with ``--trace --profile`` in the workers
             and the server: the span names are rows of each torch
             profile beside the B1/B2 kernel rows.
25. recovery — the lost-file plane and the push shuffle, each part's
             ``result.P*``, ``model.ckpt`` and ``model.meta`` byte-equal
             to phase 21's LocalExecutor run and its launches the
             code's (5 B1 and 1 B2 per map body the workers' ``--report``
             files count, re-runs included; 2 and 1 per iteration in the
             server): (a) phase 24's pool, pipelined v2 on ``object:``,
             ``replication=2``, under phase 24's plan plus one placement
             tag dark for the first iterations — the blackout fired,
             faults fired equal ``faults_injected``, reads failed over,
             no job BROKEN; (b) ``coding="4+2"`` with ``push=True`` on
             ``shared:`` under a plan that makes block 0 of every stripe
             unreadable, the workers' push budget below a map's output —
             reduces decode from the survivors, maps push frames and
             evict; (c) ``replication=2``: every copy of iteration 2's
             first reduce job's input runs removed — the workers' error
             records name them, the server requeues the producing maps,
             the workers re-run them on the card; (d) the port's extsort
             (CloudSort-style, ~110 B a record; 16 × 65,536 records, 16
             range partitions) through ``cli.execute_server --push
             --coding 4+2 --segment-format v2 --inline-workers 4`` on
             ``object:``: globally sorted, equal to a plain sort of the
             regenerated records and to a push-off barrier v1 run's
             bytes; records/s, push frames and evictions.
26. native, speculation — the native C++ host plane and speculative
             duplicate leases: (a) phase 21's digits task through
             ``Server(FileJobStore(engine="native"), speculation=3.0)``
             and two ``execute_worker`` processes on ``shared:`` (the
             native index carries every claim, the native record merge
             every reduce); in iteration 2 this process claims one map
             job and never acts on it — the straggler detector opens a
             duplicate lease, a worker's clone runs the map body on the
             card and wins: files byte-equal to phase 21's
             LocalExecutor, spec_launched ≥ 1, spec_wins ≥ 1, every job
             at zero repetitions (no stale requeue), launches 5 B1 + 1
             B2 per map body with the clone counted; (b) word count at
             Europarl's published shape (197 files × 10,000 lines × 25
             words from the seed, bigtask's split names) through
             ``cli.execute_server.main`` with ``--pipeline
             --inline-workers 4`` on ``shared:`` in a child process whose
             native entry points are wrapped in counters: every index
             the native one, every map native, every reduce the fused
             native sum; counts equal a naive count; words/s beside
             phase 24(b)'s, the corpus build timed apart; (c) 16 files ×
             750 lines run natively and in a child with
             ``LMR_DISABLE_NATIVE=1``: result bytes equal. (b) and (c)
             launch no kernel (the device idles).
27. sched — watch/notify wakeups, the HA leader lease, autotune and
             fair share, each part byte-equal to phase 21's
             LocalExecutor run: (a) phase 21's digits task on
             ``object:`` through two ``execute_worker`` processes, the
             leader a ``Server(ha=True, lease_ttl_s=HA_TTL_S)`` in a
             child process and a hot standby ``Server(ha=True)`` a thread
             of this process; once the standby has stood by and an
             iteration ≥ 2 has a map job WRITTEN and others not, the
             leader is SIGKILLed: the standby takes over (epoch 2, holder
             "" at the end, zero repetitions, launches 5 B1 + 1 B2 per
             map body) and the seconds from the kill to its
             ``leader.takeover`` span are printed; (b) the task through
             ``cli.execute_server.main --autotune --inline-workers 2
             --autotune-max-workers 4 --batch-k 8 --trace`` in this
             process: every controller decision with its
             ``autotune.<knob>`` span, no knob reversed more than once,
             no job repeated, the fleet sizes seen; (c) one FileJobStore
             shared by two tenants — the digits task ("train", a stock
             Server over a ``TenantView``) and a flood of 150 one-record
             map jobs — served by 3 ``FairWorker`` threads on one
             ``FairScheduler``: per-tenant dispatch p50/p99 beside a
             one-tenant FIFO leg's (not gated); (d) phase 21's pool
             traced with notify on and with ``LMR_SCHED_NOTIFY=0``:
             byte-equal, ms/iteration and the insert→claim dispatch
             p50/p99 of each.
28. lockcheck — the runtime lock-order sanitizer around the port on the
             card: a child process runs ``utils/lockcheck.py`` by path
             (the sanitizer in place before the package's first lock
             exists), which runs phase 21's digits task through
             ``cli.execute_server.main`` on a ``MemJobStore`` with two
             inline workers, ``shared:`` spill, ``--pipeline``,
             ``--speculation-factor 3``, ``--ha`` and notify wakeups,
             then checks every observed lock site and acquisition order
             against the port's static model (``analysis.lockset.
             static_lock_model``): files byte-equal to phase 21's
             LocalExecutor, no violation, acquisitions > 0, the launch
             counter's lock (``ops/__init__.py``) taken at least once a
             launch, launches 5 B1 + 1 B2 per map body (2 + 1 per
             finalfn), and a negative control: the model with one
             observed order taken out must report that order.
29. roofline — ``utils/roofline.py`` on the card, under 15 s: the card's
             name and power limit, its bf16 and HBM peaks from the
             module's table (which also gives every bound and MFU of
             this run; an unknown card fails the run at its start); the
             module's probe (a best-of-3 4096³ bf16 ``torch.matmul``)
             read at most 1.05 × the table's bf16 peak; B1 bf16 at 8192³
             (``ops.matmul``) timed by ``roofline.best_time`` and its
             ``roofline.mfu`` printed, 4 launches; and the MFU lines of
             phases 5, 8 and 10 (each ``roofline.mfu`` of that phase's
             own FLOPs and seconds) printed beside it.

Launch counts are zeroed just before each run of phases 4, 5, 6, 8, 10 and
15-29 (the worker processes of phases 21, 24-28 start at zero) and
read just after, and must equal the counts worked out from the code; a
kernel of the paths with no launch there fails the run. The
card's name and power limit (after a ``[time]`` line of seconds for each
phase), then one JSON line of per-kernel numbers,
then ``{"ok": true, "device": {...}}`` end the output; the full report
is also written to ``chiprun_out/chip_smoke.json``. Exits non-zero
without printing a result when CUDA is unavailable or the port cannot
be imported.
"""

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time


# H100 SXM data-sheet FP32 FMA peak outside the tensor cores (the
# roofline module keeps no f32 table)
PEAK_F32_FLOPS = 67e12
# phase 29: the probe may read at most this share of the table's peak,
# B1 bf16 is timed at this size, and the phase takes less than this
PROBE_SLACK, ROOFLINE_N, ROOFLINE_LIMIT_S = 1.05, 8192, 15

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "lua_mapreduce_tpu_torch/ops/csrc/"
KERNEL_META = {
    "matmul_f32": (CSRC + "matmul.cu", "lua_mapreduce_tpu/ops/matmul.py:34"),
    "matmul_bf16": (CSRC + "matmul.cu", "lua_mapreduce_tpu/ops/matmul.py:34"),
    "rowwise_softmax": (CSRC + "softmax.cu",
                        "lua_mapreduce_tpu/ops/softmax.py:24"),
    "flash_fwd": (CSRC + "flash.cu", "lua_mapreduce_tpu/ops/attention.py:188"),
    "flash_bwd_dq": (CSRC + "flash_bwd.cu",
                     "lua_mapreduce_tpu/ops/attention.py:419"),
    "flash_bwd_dkv": (CSRC + "flash_bwd.cu",
                      "lua_mapreduce_tpu/ops/attention.py:452"),
    "decode": (CSRC + "decode.cu", "lua_mapreduce_tpu/ops/decode.py:108"),
    "q8": (CSRC + "q8.cu", "lua_mapreduce_tpu/ops/q8.py:59"),
    "pool": (CSRC + "pool.cu", "lua_mapreduce_tpu/ops/pool.py:24"),
}
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
# a cold kernel row rotates its weight over copies of at least this many
# bytes (twice the H100's 50 MB L2), so each call reads it from HBM
COLD_BYTES = 100 * 2 ** 20
# the JAX package's op tolerances for the serving kernels
# (test_attention_op.py, test_decode_op.py, test_q8.py)
SERVE_TOL = {"flash float32": (2e-5, 2e-5), "flash bfloat16": (2e-2, 2e-2),
             "decode float32": (2e-5, 2e-5), "decode bfloat16": (2e-2, 2e-2),
             "decode int8": (5e-3, 5e-3), "q8": (2e-2, 2e-2)}
# A bf16 or int8 serving row must also hold ‖got − want‖ / ‖want‖ to
# this: an elementwise tolerance near the size of the values it holds
# would pass a kernel that is wrong in every element.
NORM_TOL = 1e-2
# Attention inputs at the serving shapes are drawn so the softmax is
# peaked (scores of std 2: q at scale 2, k and v at 1) and the outputs
# are O(0.1-1), where the tolerances above mean something. A wrong
# output — the plain version with its softmax scale 5% off — must fail
# the same check (a negative control on every attention row).
Q_SCALE, WRONG_SCALE = 2.0, 1.05
# int8 weights + int8 KV cache at 2 layers: the card's head logits at
# every decode step up to the first token where it parts from the CPU
# reference may differ from the reference's by at most this, and the
# reference's own margin between its token and the card's there must be
# within it (a near-tie, not a wrong kernel).
INT8_LOGIT_TOL = 2e-2
# bench_decode's configuration (benchmarks/kernel_bench.py:533-567)
SERVE = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096,
             max_seq=4096)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 3968, 128
# bench_transformer_step's configuration (benchmarks/kernel_bench.py:380-
# 418): d1024 h16 L8 ff4096 v32768, seq 2048, batch 8, bf16,
# optax.sgd(1e-3, momentum=0.9), attn="ring" on one device; its modern
# variant is llama_style with 4:1 GQA
LM = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096,
          max_seq=2048)
LM_BATCH, LM_SEQ, LM_STEPS = 8, 2048, 10
LM_MODERN = dict(rope=True, norm="rms", ffn="swiglu", n_kv_heads=4)
# the f32 card-vs-CPU LM check: 2 layers, seq 256, batch 2, three free-
# running steps; losses within LM_CHECK_RTOL relative, gradients and
# parameter updates normwise within LM_CHECK_NORM over all parameters and
# in the worst one (GELU/SwiGLU are smooth: no ReLU kinks, LeNet's limits)
LM_CHECK_RTOL, LM_CHECK_NORM = 1e-4, 1e-4
# the check's SGD rate (the JAX parity tests'). Its parameter update is
# the one the optimizer applies, −lr·b from the momentum buffer b: read
# as after − before in f32 instead, an update carries the last-bit
# rounding of p − lr·b on each side, which alone parted the two sides by
# 5e-5 normwise at lr 1e-3 (7e-5 in a norm gain at lr 0.1) while the
# gradients agreed to 2e-6
LM_CHECK_LR = 0.1
# bench_conv_train's configurations (benchmarks/kernel_bench.py:457-530,
# :788-793): model, batch, timed steps
CONV_RUNS = (("lenet5_cifar", 1024, 10), ("resnet18_imagenet", 32, 5))
# the f32 card-vs-CPU conv check: each step's loss agrees within
# CONV_CHECK_RTOL (relative); its gradient and its parameter update (SGD
# with momentum) agree normwise within the model's limits, over all
# parameters together and in the worst single parameter. LeNet (tanh,
# no ReLU) runs free for its three steps. A ReLU network's gradient
# jumps at activation kinks: at the ResNet check's images a 1e-6
# relative change of the input moves the JAX package's own gradient by
# 0.65% normwise (1.4% in s3b0_n1_be), and the card and the CPU part
# there (a free second step's loss then differs by 6e-4), while a wrong
# kernel moves a gradient by O(1). So ResNet's card parameters are set
# to the CPU run's before each step, and its limits are wider.
CONV_CHECK_RTOL = 1e-4
# model: (batch, input shape, free-running, normwise limit over all
# parameters, normwise limit in the worst parameter)
CONV_CHECKS = {"lenet5_cifar": (64, None, True, 1e-4, 1e-4),
               "resnet18_imagenet": (4, (64, 64, 3), False, 2e-2, 5e-2)}
# the data-parallel plane's configurations (PR 10): k-means at SIFT1M's
# shape (1,000,000 points of 128 f32, k = 1024; synthetic blobs from the
# seed, not the dataset), 20 Lloyd iterations; ALS at MovieLens-1M's
# shape (6,040 users × 3,706 items, 4.47% observed; a low-rank-plus-
# noise matrix from the seed), rank 64, reg 0.1, 10 rounds; the DP
# trainer's timed captured steps per model (a digits step is ~0.1 ms:
# 200 of them keep the host clock's noise out of the figure)
KMEANS_N, KMEANS_K, KMEANS_DIM, KMEANS_ITERS = 1_000_000, 1024, 128, 20
ALS_USERS, ALS_ITEMS, ALS_DENSITY, ALS_RANK, ALS_ITERS, ALS_REG = (
    6040, 3706, 0.0447, 64, 10, 0.1)
DP_STEPS = {"digits": 200, "lenet5_cifar": 20}
# the compiled MapReduce tiers' configurations (PR 11): mr_sgd at the
# flagship width (BASELINE's digits run: 256-128-10, 4 shards × bunch
# 128), 20 loop iterations; mr_kmeans at SIFT1M's shape (phase 15's
# blobs), 8 shards, 3 iterations; mr_als at MovieLens-100K's shape (943
# users × 1,682 items, 6.3% observed; a low-rank-plus-noise matrix from
# the seed), rank 32, reg 0.1, 4 shards, 5 rounds
SGD_ARGS = {"dim": 256, "hidden": 128, "n_shards": 4, "bunch": 128,
            "max_steps": 20, "seed": 0}
MRKM_SHARDS, MRKM_ITERS = 8, 3
MRALS_ARGS = {"n_users": 943, "n_items": 1682, "rank": 32,
              "density": 0.063, "reg": 0.1, "n_shards": 4,
              "max_iters": 5, "seed": 0, "coord": "mem"}
# mr_als solves the item step in float64 on the host, als_fit in f32 by
# Cholesky on the card: after 5 rounds their item factors agree within
# these, normwise and in the largest element (a CPU run at this shape:
# 1.6e-5 and 3.4e-4)
MRALS_NORM_TOL, MRALS_ABS_TOL = 1e-4, 2e-3
# phase 20's int-sum task of wordcount's shape: 8 map jobs of 2,048
# token ids over 48 words (Zipf-distributed from the seed; 48 keeps the
# reduce fold's proof cache, one proof per word, under its 64), counts
# summed by an accumulator loop, 4 partitions
WORDIDS_TASK = """
import torch

def taskfn(emit):
    import numpy as np
    rng = np.random.RandomState(0)
    for j in range(8):
        ids = np.minimum(rng.zipf(1.3, 2048) - 1, 47)
        emit(j, {"ids": ids.tolist()})

def mapfn(key, value, emit):
    ids = torch.as_tensor(value["ids"], dtype=torch.int32)
    counts = torch.sum(ids[:, None] == torch.arange(48, device=ids.device),
                       dim=0)
    for w in range(48):
        emit(w, counts[w])

def partitionfn(key):
    return int(key) % 4

def reducefn(key, values):
    acc = values[0]
    for i in range(1, len(values)):
        acc = acc + values[i]
    return acc

reducefn.associative_reducer = True
reducefn.commutative_reducer = True

def finalfn(pairs):
    return False        # one iteration; the results stay
"""


def log(msg):
    print(msg, flush=True)


def time_ms(fn, torch):
    """Device ms per call. After warm-up calls, enough calls to fill
    ~0.1 s are captured into one CUDA graph and the graph's replay is
    timed by CUDA events: the host's cost of launching each call (tens
    of µs through Python, more than a small kernel takes on the card)
    stays out of the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        est = time.perf_counter() - t0
    torch.cuda.current_stream().wait_stream(side)
    reps = int(min(200, max(3, 0.1 / max(est, 1e-6))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / peaks()[1]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def norm_err(got, want):
    """‖got − want‖ / ‖want‖ over the whole tensor, in f32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def check_close(name, got, want, dtype_name, tol=None, norm_tol=None):
    """Max abs error of ``got`` against ``want``; raises unless every
    element is within ``atol + rtol·|want|`` and, with ``norm_tol``, the
    normwise relative error is within it."""
    rtol, atol = tol or TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(g.isfinite().all()) and bool((err <= atol + rtol * w.abs()).all())
    max_abs = float(err.max()) if err.numel() else 0.0
    del err
    rel = norm_err(g, w) if norm_tol is not None else 0.0
    if not ok or rel > (norm_tol or 0.0):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (max abs err {max_abs:.3e}, "
                             f"rtol={rtol}, atol={atol}; normwise {rel:.3e}, "
                             f"limit {norm_tol})")
    return max_abs


def assert_rejects(name, wrong, want, dtype_name, tol, norm_tol):
    """The negative control: ``check_close`` must refuse ``wrong``.
    Returns its normwise error."""
    try:
        check_close(name, wrong, want, dtype_name, tol, norm_tol)
    except AssertionError:
        return norm_err(wrong, want)
    raise AssertionError(f"{name}: the check passed a wrong output "
                         f"(normwise {norm_err(wrong, want):.3e})")


# ------------------------------------------------------------ phase 2

def matmul_cases():
    """(label, M, K, N, dtype, a transposed?, b transposed?, the plan
    csrc/matmul.cu must take: kernel, A's copy mode, B's copy mode) at
    the main path's shapes: the digits step's forward products, its
    backward products (transposed views, as the autograd Function passes
    them), the validation products, the data-parallel plane's k-means
    and ALS products, and the wide trainer's 8192³ products."""
    small = ("f32 64x64", None, None)
    f32 = [("digits fwd x·W0", 128, 256, 128, False, False, small),
           ("digits fwd h·W1", 128, 128, 10, False, False, small),
           ("digits bwd g·W1ᵀ", 128, 10, 128, False, True, small),
           ("digits bwd hᵀ·g", 128, 128, 10, True, False, small),
           ("digits bwd xᵀ·g", 256, 128, 128, True, False, small),
           ("digits val x·W0", 200, 256, 128, False, False, small),
           ("digits val h·W1", 200, 128, 10, False, False, small)]
    # k-means at SIFT1M's shape: x·cᵀ (c read through its .t() view) and
    # one_hotᵀ·x (K = 10⁶, split-K, one_hot through its .t() view); ALS at
    # ML-1M's: W·(V⊗V), Wᵀ·(U⊗U) (Wᵀ's rows 3,706 floats: 8-byte pieces),
    # the right-hand sides (w·r)·V and (w·r)ᵀ·U, and U·Vᵀ
    wide = "f32 128x128"
    f32 += [("kmeans x·cᵀ", KMEANS_N, KMEANS_DIM, KMEANS_K, False, True,
             (wide, "e4k", "e4k")),
            ("kmeans one_hotᵀ·x", KMEANS_K, KMEANS_N, KMEANS_DIM, True,
             False, (wide, "v16", "v16")),
            ("als W·(V⊗V)", ALS_USERS, ALS_ITEMS, ALS_RANK ** 2, False,
             False, (wide, "e4k", "v16")),
            ("als Wᵀ·(U⊗U)", ALS_ITEMS, ALS_USERS, ALS_RANK ** 2, True,
             False, (wide, "v8", "v16")),
            ("als (w·r)·V", ALS_USERS, ALS_ITEMS, ALS_RANK, False, False,
             ("f32 128x64", "e4k", "v16")),
            ("als (w·r)ᵀ·U", ALS_ITEMS, ALS_USERS, ALS_RANK, True, False,
             ("f32 128x64", "v8", "v16")),
            ("als U·Vᵀ", ALS_USERS, ALS_RANK, ALS_ITEMS, False, True,
             (wide, "e4k", "e4k"))]
    tma = ("bf16 tma", None, None)
    bf16 = [("4096³", 4096, 4096, 4096, False, False, tma),
            ("wide fwd 8192³", 8192, 8192, 8192, False, False, tma),
            ("wide bwd g·Wᵀ", 8192, 8192, 8192, False, True, tma),
            ("wide bwd hᵀ·g", 8192, 8192, 8192, True, False, tma)]
    return ([(*c[:4], "float32", *c[4:]) for c in f32] +
            [(*c[:4], "bfloat16", *c[4:]) for c in bf16])


def phase_kernels(torch, ops, gen):
    from lua_mapreduce_tpu_torch.ops.matmul import (matmul_cuda,
                                                    matmul_kernel_plan,
                                                    matmul_plain)
    from lua_mapreduce_tpu_torch.ops.softmax import (log_softmax_plain,
                                                     rowwise_softmax_cuda,
                                                     softmax_kernel_plan,
                                                     softmax_plain)
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, m, k, n, dt, ta, tb, want in matmul_cases():
        dtype = getattr(torch, dt)
        scale = k ** -0.25
        a = (torch.randn((k, m) if ta else (m, k), device="cuda",
                         generator=gen) * scale).to(dtype)
        b = (torch.randn((n, k) if tb else (k, n), device="cuda",
                         generator=gen) * scale).to(dtype)
        a, b = (a.t() if ta else a), (b.t() if tb else b)
        plan = matmul_kernel_plan(a, b)
        if (plan.kernel, plan.a_copy, plan.b_copy) != want:
            raise AssertionError(f"matmul {label} took {plan}, expected "
                                 f"{want}")
        # the f32 kernels' only split product must fill the card
        tiles = -(-m // 128) * -(-n // 128)
        if (label == "kmeans one_hotᵀ·x"
                and tiles * plan.splits < sms):
            raise AssertionError(f"matmul {label}: {tiles} tiles x split "
                                 f"{plan.splits} leave SMs of {sms} idle")
        got = matmul_cuda(a, b, dtype)
        torch.cuda.synchronize()
        err = check_close(f"matmul {label}", got, matmul_plain(a, b, dtype),
                          dt)
        item = 2 if dtype == torch.bfloat16 else 4
        bms, by = bound(2 * m * n * k, (m * k + k * n + m * n) * item,
                        peaks()[0] if dt == "bfloat16"
                        else PEAK_F32_FLOPS)
        rows.append({
            "kernel": "matmul_f32" if dt == "float32" else "matmul_bf16",
            "case": f"matmul {label} ({m},{k})x({k},{n}) {dt}",
            "splits": plan.splits, "path": plan.kernel,
            "copies": (f"{plan.a_copy}/{plan.b_copy}" if plan.a_copy
                       else None),
            "max_abs_err": err,
            "ms": time_ms(lambda: matmul_cuda(a, b, dtype), torch),
            "plain_ms": time_ms(lambda: matmul_plain(a, b, dtype), torch),
            "library_ms": time_ms(lambda: torch.matmul(a, b), torch),
            "bound_ms": bms, "bound_by": by})
        del a, b, got
    # the digits step and validation, the wide step, the logits of the
    # LeNet b1024 and ResNet-18 b32 steps (log_softmax only there), and a
    # vocab-wide row (the LM's 32768 classes, 128 MiB); each with the
    # branch of csrc/softmax.cu it must take
    for shape, dt, modes, branch in (
            ((128, 10), "float32", (0, 1), "warp/scalar"),
            ((200, 10), "float32", (0, 1), "warp/scalar"),
            ((8192, 8192), "bfloat16", (0, 1), "regs/v16"),
            ((1024, 10), "bfloat16", (0,), "warp/scalar"),
            ((32, 1000), "bfloat16", (0,), "warp/v16"),
            ((1024, 32768), "bfloat16", (0,), "stream/v16")):
        dtype = getattr(torch, dt)
        x = (torch.randn(shape, device="cuda", generator=gen) * 3).to(dtype)
        ntol = NORM_TOL if dt == "bfloat16" else None
        took = softmax_kernel_plan(x).name
        if took != branch:
            raise AssertionError(f"softmax {shape} {dt} took the {took} "
                                 f"branch, expected {branch}")
        for mode, name, plain, lib in (
                (0, "log_softmax", log_softmax_plain, torch.log_softmax),
                (1, "softmax", softmax_plain, torch.softmax)):
            if mode not in modes:
                continue
            got = rowwise_softmax_cuda(x, mode)
            torch.cuda.synchronize()
            err = check_close(f"{name} {shape}", got, plain(x), dt,
                              norm_tol=ntol)
            if mode == 0:
                assert bool(torch.isfinite(got).all())
            if not torch.equal(rowwise_softmax_cuda(x, mode), got):
                raise AssertionError(f"{name} {shape}: two calls differ")
            item = 2 if dtype == torch.bfloat16 else 4
            numel = shape[0] * shape[1]
            # ~5 f32 operations per element: max, sub, exp, add, sub/mul
            bms, by = bound(5 * numel, 2 * numel * item, PEAK_F32_FLOPS)
            rows.append({
                "kernel": "rowwise_softmax", "branch": took,
                "case": f"{name} {shape} {dt}", "max_abs_err": err,
                "norm_err": norm_err(got, plain(x)) if ntol else None,
                "ms": time_ms(lambda: rowwise_softmax_cuda(x, mode), torch),
                "plain_ms": time_ms(lambda: plain(x), torch),
                "library_ms": time_ms(lambda: lib(x, dim=-1), torch),
                "bound_ms": bms, "bound_by": by})
    # the digits extreme-value row stays finite through the kernel
    ext = torch.tensor([[1e4, -1e4, 0.0, 5.0]], device="cuda")
    got = rowwise_softmax_cuda(ext, 0)
    check_close("log_softmax extreme values", got, log_softmax_plain(ext),
                "float32")
    return rows


def visible_pairs(l, causal, window):
    """(query, key) pairs a causal/windowed attention over L rows sees."""
    if not causal:
        return l * l
    if not window or window >= l:
        return l * (l + 1) // 2
    return window * (window + 1) // 2 + (l - window) * window


def serving_row(torch, kernel, case, err, fn, plain, lib, flops, nbytes,
                peak, rel, control=None):
    """One phase-2 row; ``rel`` is the kernel's normwise error against
    the plain version, ``control`` the wrong output's, which the check
    refused."""
    bms, by = bound(flops, nbytes, peak)
    return {"kernel": kernel, "case": case, "max_abs_err": err,
            "norm_err": rel, "control_norm_err": control,
            "ms": time_ms(fn, torch), "plain_ms": time_ms(plain, torch),
            "library_ms": time_ms(lib, torch) if lib else None,
            "bound_ms": bms, "bound_by": by}


def phase_serving_kernels(torch, gen):
    """flash / decode / q8 against their plain versions at the serving
    path's shapes (batch 4, prompt 3968, 16 heads of 64, cache 4096;
    q8 at every projection and the head, decode M = 4 and prefill
    M = 15872), plus the f32 shapes of the reduced-depth check. bf16 and
    int8 rows are also held normwise (NORM_TOL), and every attention
    row shows that its check refuses a wrong output."""
    import torch.nn.functional as F
    from lua_mapreduce_tpu_torch import ops
    from lua_mapreduce_tpu_torch.ops.attention import (flash_attention_cuda,
                                                       flash_attention_plain,
                                                       flash_kernel_path)
    from lua_mapreduce_tpu_torch.ops.decode import (_KINDS, _KIND_BF16_INT8,
                                                    _merge_splits_plain,
                                                    decode_attention_cuda,
                                                    decode_attention_plain,
                                                    decode_splits,
                                                    merge_splits_cuda)
    rows = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=gen)
                * scale).to(dtype)

    def misaligned(*shape, dtype, scale=1.0):
        """A [..., 1:] view of a tensor one element wider: its base and
        head stride are off 16 bytes, so only the general kernel reads
        it."""
        return randn(*shape[:-1], shape[-1] + 1, dtype=dtype,
                     scale=scale)[..., 1:]

    # ---- flash: prefill (B, L, H, D), causal, one call per layer; the
    # main paths' bf16 rows must take the TMA + wgmma kernel, and one row
    # drives the general kernel at the prefill shape through a
    # misaligned view
    for label, b, l, h, hkv, d, dt, window, lse, want_path in (
            ("prefill causal", 4, 3968, 16, 16, 64, "bfloat16", 0, False,
             "tma"),
            ("prefill causal, lse mode", 4, 3968, 16, 16, 64, "bfloat16", 0,
             True, "tma"),
            ("GQA 4:1 causal", 4, 3968, 16, 4, 64, "bfloat16", 0, False,
             "tma"),
            ("LM training causal, lse mode", 8, 2048, 16, 16, 64,
             "bfloat16", 0, True, "tma"),
            ("LM training GQA 4:1 causal, lse mode", 8, 2048, 16, 4, 64,
             "bfloat16", 0, True, "tma"),
            ("window 512", 4, 3968, 16, 16, 64, "bfloat16", 512, False,
             "tma"),
            ("prefill causal, misaligned view", 4, 3968, 16, 16, 64,
             "bfloat16", 0, False, "general"),
            ("check-run prefill causal", 4, 256, 16, 16, 64, "float32", 0,
             False, "f32")):
        dtype = getattr(torch, dt)
        make = misaligned if want_path == "general" else randn
        q = make(b, l, h, d, dtype=dtype, scale=Q_SCALE)
        k = make(b, l, hkv, d, dtype=dtype)
        v = make(b, l, hkv, d, dtype=dtype)
        path = flash_kernel_path(q, k, v)
        if path != want_path:
            raise AssertionError(f"flash {label}: took the {path} kernel, "
                                 f"expected {want_path}")
        scale = d ** -0.5
        tol = SERVE_TOL[f"flash {dt}"]
        ntol = NORM_TOL if dt == "bfloat16" else None

        def run(q=q, k=k, v=v, window=window, lse=lse):
            return flash_attention_cuda(q, k, v, causal=True, window=window,
                                        with_lse=lse)

        def plain(q=q, k=k, v=v, window=window, lse=lse, scale=scale):
            return flash_attention_plain(q, k, v, True, scale,
                                         with_lse=lse, window=window)
        got, want = run(), plain()
        torch.cuda.synchronize()
        out_got, out_want = (got[0], want[0]) if lse else (got, want)
        err = check_close(f"flash {label}", out_got, out_want, dt, tol, ntol)
        rel = norm_err(out_got, out_want)
        if lse:
            err = max(err, check_close(f"flash {label} lse", got[1], want[1],
                                       dt, (1e-5, 1e-4)))
        wrong = flash_attention_plain(q, k, v, True, scale * WRONG_SCALE,
                                      with_lse=lse, window=window)
        control = assert_rejects(f"flash {label} (scale 5% off)",
                                 wrong[0] if lse else wrong, out_want, dt,
                                 tol, ntol)
        del got, want, out_got, out_want, wrong
        lib = None
        if want_path == "general":
            pass                 # SDPA's yardstick is the aligned row's
        elif lse and hkv == h:
            # the flash SDPA op returns the logsumexp too (equal kv heads)
            lib = sdpa_flash_fwd(torch, q, k, v)
        elif not lse:
            mask = None
            if window:
                i = torch.arange(l, device="cuda")
                mask = (i[:, None] >= i[None, :]) & \
                    (i[:, None] - i[None, :] < window)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def lib(qt=qt, kt=kt, vt=vt, mask=mask, gqa=hkv != h):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=gqa)
        item = q.element_size()
        nbytes = (2 * b * l * h * d + 2 * b * l * hkv * d) * item
        if lse:
            nbytes += b * l * h * d * (4 - item) + b * l * h * 4
        flops = 4 * b * h * d * visible_pairs(l, True, window)
        rows.append({**serving_row(
            torch, "flash_fwd", f"flash {label} ({b},{l},{h}/{hkv},{d}) {dt}", err,
            run, plain, lib, flops, nbytes,
            peaks()[0] if dt == "bfloat16" else PEAK_F32_FLOPS,
            rel, control), "path": path})
        del q, k, v
        torch.cuda.empty_cache()

    # ---- decode: one position vs the (B, H_kv, S, D) cache, per layer
    for label, b, hkv, g, d, s_len, t, kind, roll in (
            ("bf16 t=4094", 4, 16, 1, 64, 4096, 4094, "bfloat16", False),
            ("int8+scales t=4094", 4, 16, 1, 64, 4096, 4094, "int8", False),
            ("roll S=512 t=4000", 4, 16, 1, 64, 512, 4000, "bfloat16", True),
            ("GQA 4:1 t=4094", 4, 4, 4, 64, 4096, 4094, "bfloat16", False),
            ("check-run f32 t=287", 4, 16, 1, 64, 288, 287, "float32",
             False)):
        dtype = torch.float32 if kind == "float32" else torch.bfloat16
        q = randn(b, hkv, g, d, dtype=dtype, scale=Q_SCALE)
        k = randn(b, hkv, s_len, d, dtype=dtype)
        v = randn(b, hkv, s_len, d, dtype=dtype)
        kd, vd = k, v
        scales = {}
        if kind == "int8":
            k, ks = ops.quantize_kv(kd)
            v, vs = ops.quantize_kv(vd)
            scales = dict(k_scale=ks, v_scale=vs)
            kd = (k.float() * ks[..., None]).to(torch.bfloat16)
            vd = (v.float() * vs[..., None]).to(torch.bfloat16)

        # the position as the captured decode loop passes it: a device
        # scalar the kernel reads
        t_dev = torch.full((), t, dtype=torch.int64, device="cuda")

        def run(q=q, k=k, v=v, t=t_dev, roll=roll, scales=scales):
            return decode_attention_cuda(q, k, v, t, roll, **scales)

        def plain(q=q, k=k, v=v, t=t_dev, roll=roll, scales=scales):
            return decode_attention_plain(q, k, v, t, roll, **scales)
        got, want = run(), plain()
        torch.cuda.synchronize()
        # the split grid and a fixed-order combine: two calls bit-equal
        if not torch.equal(run(), got):
            raise AssertionError(f"decode {label}: two calls differ")
        n_split = decode_splits(b * hkv, s_len, d, g,
                                _KIND_BF16_INT8 if scales else _KINDS[dtype])
        tol = SERVE_TOL[f"decode {kind}"]
        ntol = NORM_TOL if kind != "float32" else None
        err = check_close(f"decode {label}", got, want, kind, tol, ntol)
        rel = norm_err(got, want)
        # the softmax scale 5% off: q scaled, since the scale is 1/√d
        control = assert_rejects(
            f"decode {label} (scale 5% off)",
            decode_attention_plain((q.float() * WRONG_SCALE).to(q.dtype), k,
                                   v, t, roll, **scales),
            want, kind, tol, ntol)
        del got, want
        n_live = s_len if (roll and t >= s_len) else min(t + 1, s_len)
        qs = q.reshape(b, hkv * g, 1, d)
        kp, vp = kd[:, :, :n_live], vd[:, :, :n_live]

        def lib(qs=qs, kp=kp, vp=vp, gqa=g > 1):
            return F.scaled_dot_product_attention(qs, kp, vp,
                                                  enable_gqa=gqa)
        kv_item = k.element_size()
        nbytes = (2 * b * hkv * n_live * d * kv_item + q.numel()
                  * q.element_size() + b * hkv * g * d * 4)
        if scales:
            nbytes += 2 * b * hkv * n_live * 4
        rows.append({**serving_row(
            torch, "decode", f"decode {label} q ({b},{hkv},{g},{d}) cache S={s_len} "
            f"{kind}", err, run, plain, lib, 4 * b * hkv * g * n_live * d,
            nbytes, PEAK_F32_FLOPS if kind == "float32" else peaks()[0],
            rel, control), "n_split": n_split, "bit_equal": True})
        del q, k, v, kd, vd
        torch.cuda.empty_cache()

    # ---- decode's combine alone, on split states at the serving shape
    # (64 rows, the serving n_split), one split of one row empty
    r_, n_, g_, d_ = 64, decode_splits(64, 4096, 64, 1, _KINDS[torch.bfloat16]), 1, 64
    pm = torch.randn((r_, n_, g_), device="cuda", generator=gen) * 3
    pl = torch.rand((r_, n_, g_), device="cuda", generator=gen) + 0.5
    pacc = torch.randn((r_, n_, g_, d_), device="cuda", generator=gen)
    pm[3, n_ - 1], pl[3, n_ - 1], pacc[3, n_ - 1] = -1e30, 0.0, 0.0

    def run(pm=pm, pl=pl, pacc=pacc):
        return merge_splits_cuda(pm, pl, pacc)

    def plain(pm=pm, pl=pl, pacc=pacc):
        return _merge_splits_plain(pm, pl, pacc)
    got, want = run(), plain()
    if not torch.equal(run(), got):
        raise AssertionError("decode combine: two calls differ")
    err = check_close("decode combine", got, want, "float32",
                      SERVE_TOL["decode float32"])
    nbytes = (pm.numel() + pl.numel() + pacc.numel() + got.numel()) * 4
    rows.append({**serving_row(
        torch, "decode", f"decode combine ({r_} rows, {n_} splits, G {g_}, "
        f"D {d_}) f32", err, run, plain, None, 4 * pacc.numel(), nbytes,
        PEAK_F32_FLOPS, norm_err(got, want)), "n_split": n_,
        "bit_equal": True})
    del pm, pl, pacc, got, want

    rows += q8_rows(torch, gen)
    return rows


def cold_copies(torch, t, total_bytes=COLD_BYTES):
    """Copies of ``t`` enough to hold ``total_bytes`` (at least two), so
    that a call that takes the next copy each time finds its operand
    evicted from L2 by the others."""
    n = max(2, -(-total_bytes // (t.numel() * t.element_size())))
    return [t.clone() for _ in range(n)]


def rotating(fn, copies):
    """A call of ``fn(copy)`` on the next of ``copies`` each time: the
    calls a CUDA graph captures keep their copies, so its replay reads
    each from device memory."""
    turn = [0]

    def call():
        c = copies[turn[0] % len(copies)]
        turn[0] += 1
        return fn(c)
    return call


def q8_rows(torch, gen):
    """q8 against its plain version at every product quantize_lm makes in
    serving: the decode projections and head at M = 4 (and the head at
    M = 1, 2 and 8), prefill at M = 15872, the f32 check run. A decode
    row names the GEMV's plan (strip width, cluster split, CTAs), is held
    bit-equal over two calls, and is timed warm and cold: cold rotates
    the weight (and torch.matmul's bf16 weight) over COLD_BYTES of
    copies, so each call reads it from device memory, as a decode step
    that streams every layer's weights does."""
    from lua_mapreduce_tpu_torch import ops
    from lua_mapreduce_tpu_torch.ops import _build
    from lua_mapreduce_tpu_torch.ops.q8 import (GEMV_COLS, GEMV_MAX_M,
                                                q8_gemv_cuda, q8_gemv_plan,
                                                q8_matmul_cuda,
                                                q8_matmul_plain)
    q8_lib = _build.library("q8")
    rows = []
    for label, m, k_dim, n, dt in (
            ("decode qkv", 4, 1024, 3072, "bfloat16"),
            ("decode out", 4, 1024, 1024, "bfloat16"),
            ("decode ff1", 4, 1024, 4096, "bfloat16"),
            ("decode ff2", 4, 4096, 1024, "bfloat16"),
            ("decode head", 4, 1024, 32768, "bfloat16"),
            ("decode head M=1", 1, 1024, 32768, "bfloat16"),
            ("decode head M=2", 2, 1024, 32768, "bfloat16"),
            ("decode head M=8", 8, 1024, 32768, "bfloat16"),
            ("prefill qkv", 15872, 1024, 3072, "bfloat16"),
            ("prefill out", 15872, 1024, 1024, "bfloat16"),
            ("prefill ff1", 15872, 1024, 4096, "bfloat16"),
            ("prefill ff2", 15872, 4096, 1024, "bfloat16"),
            ("prefill head", 15872, 1024, 32768, "bfloat16"),
            ("check-run prefill qkv (x bf16-valued)", 1024, 1024, 3072,
             "float32")):
        dtype = getattr(torch, dt)
        w = (torch.randn((k_dim, n), device="cuda", generator=gen)
             * k_dim ** -0.5)
        qw, sw = ops.quantize_q8(w)
        sw = sw.reshape(-1)
        # bf16 values: the kernel rounds x to bf16, the plain version not
        x = torch.randn((m, k_dim), device="cuda",
                        generator=gen).to(torch.bfloat16).to(dtype)
        wd = (qw.float() * sw).to(torch.bfloat16)
        xb = x.to(torch.bfloat16)

        def run(x=x, qw=qw, sw=sw):
            return q8_matmul_cuda(x, qw, sw)

        def plain(x=x, qw=qw, sw=sw):
            return q8_matmul_plain(x, qw, sw)

        def lib(xb=xb, wd=wd):
            return torch.matmul(xb, wd)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = check_close(f"q8 {label}", got, want, dt, SERVE_TOL["q8"],
                          NORM_TOL if dt == "bfloat16" else None)
        rel = norm_err(got, want)
        extra = {"splits": int(q8_lib.lmr_q8_splits(m, k_dim, n))}
        if m <= GEMV_MAX_M:
            # the cluster sums in rank order: two calls give the same bits
            if not torch.equal(run(), got):
                raise AssertionError(f"q8 {label}: two calls differ")
            plan, cluster_sms = q8_gemv_plan(m, k_dim, n)
            qs, wds = cold_copies(torch, qw), cold_copies(torch, wd)
            if m == 4:
                # every plan the kernel takes (a split no larger than K's
                # steps of 256·16/c rows), warm, beside the one it picks
                extra["plan_sweep_ms"] = {
                    f"{c}x{sp}": time_ms(
                        lambda c=c, sp=sp, x=x, qw=qw, sw=sw:
                        q8_gemv_cuda(x, qw, sw, c, sp), torch)
                    for c in GEMV_COLS for sp in (1, 2, 4, 8)
                    if sp == 1 or sp <= -(-k_dim // (4096 // c))}
            extra.update(
                cols=plan.cols, ctas=plan.ctas, bit_equal=True,
                cluster_sms=list(cluster_sms),
                cold_ms=time_ms(rotating(
                    lambda c, x=x, sw=sw: q8_matmul_cuda(x, c, sw), qs),
                    torch),
                cold_library_ms=time_ms(rotating(
                    lambda c, xb=xb: torch.matmul(xb, c), wds), torch),
                cold_copies=[len(qs), len(wds)])
            del qs, wds
        del got, want
        item = x.element_size()
        nbytes = m * k_dim * item + k_dim * n + n * 4 + m * n * item
        rows.append({**serving_row(
            torch, "q8", f"q8 {label} ({m},{k_dim})x({k_dim},{n}) x {dt}",
            err, run, plain, lib, 2 * m * k_dim * n, nbytes, peaks()[0],
            rel), **extra})
        del w, qw, x, wd, xb
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 3

def phase_grads(torch, ops, gen):
    """Digits-MLP loss and parameter gradients through the kernels
    (custom autograd Functions) against plain autograd, on the card."""
    from lua_mapreduce_tpu_torch.models.mlp import init_mlp, nll_loss
    from lua_mapreduce_tpu_torch.ops.matmul import matmul_plain
    from lua_mapreduce_tpu_torch.ops.softmax import log_softmax_plain

    def plain_loss(p, x, y):
        h = torch.tanh(matmul_plain(x, p["W0"]) + p["b0"])
        logp = log_softmax_plain(matmul_plain(h, p["W1"]) + p["b1"])
        return -logp.gather(1, y[:, None]).mean()

    out = {}
    for dt, sizes, batch in (("float32", (256, 128, 10), 128),
                             ("bfloat16", (1024, 512, 256), 512)):
        dtype = getattr(torch, dt)
        x = torch.rand((batch, sizes[0]), device="cuda",
                       generator=gen).to(dtype)
        y = torch.randint(0, sizes[-1], (batch,), device="cuda",
                          generator=gen)
        grads = []
        for fn in (nll_loss, plain_loss):
            p = {k: v.requires_grad_(True)
                 for k, v in init_mlp(1, sizes, dtype, "cuda").items()}
            loss = fn(p, x, y)
            g = torch.autograd.grad(loss, list(p.values()))
            grads.append((loss.detach(), dict(zip(p, g))))
        (lk, gk), (lp, gp) = grads
        err = check_close(f"loss {dt}", lk.reshape(1), lp.reshape(1), dt)
        for k in gk:
            err = max(err, check_close(f"grad {k} {dt}", gk[k], gp[k], dt))
        out[dt] = err
        log(f"[grads] {dt} sizes={sizes} batch={batch}: loss kernel="
            f"{float(lk):.6f} plain={float(lp):.6f} max_abs_err={err:.3e}")
    out.update(lenet_grads(torch, gen))
    return out


# ------------------------------------------------------------ phase 4

def run_digits(device, tag, n_iter):
    """The six-function digits trainer for ``n_iter`` loop iterations;
    returns the validation loss after each."""
    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    from lua_mapreduce_tpu_torch.examples.digits import mr_train

    model_store = f"mem:smoke-digits-model-{tag}"
    val = []

    def finalfn(pairs):
        verdict = mr_train.finalfn(pairs)
        val.append(mr_train.read_meta(model_store)["val_loss"])
        return verdict

    mod = "lua_mapreduce_tpu_torch.examples.digits.mr_train"
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    finalfn={"finalfn": finalfn},
                    init_args={"sizes": (256, 128, 10), "n_shards": 4,
                               "bunch": 128, "max_steps": n_iter,
                               "patience": 10_000, "seed": 0,
                               "model_store": model_store,
                               "device": device},
                    storage=f"mem:smoke-digits-shuffle-{tag}")
    t0 = time.perf_counter()
    stats = LocalExecutor(spec, max_iterations=n_iter + 1).run()
    wall = time.perf_counter() - t0
    if len(stats.iterations) != n_iter:
        raise AssertionError(f"digits ran {len(stats.iterations)} "
                             f"iterations, expected {n_iter}")
    return val, wall


def phase_digits(torch, ops, n_iter=6):
    ops.reset_launch_counts()
    val, wall = run_digits("cuda", "cuda", n_iter)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"[digits] val loss per iteration: "
        + " ".join(f"{v:.6f}" for v in val))
    log(f"[digits] {n_iter} iterations in {wall:.3f} s "
        f"({n_iter * 4 * 128 / wall:.1f} images/s, host clock); "
        f"launches {counts}")
    # per iteration: 4 map jobs × (2 forward + 3 backward products, 1
    # log_softmax) + the validation loss (2 products, 1 log_softmax)
    want = {**dict.fromkeys(ops.KERNELS, 0),
            "matmul_f32": n_iter * (4 * 5 + 2),
            "rowwise_softmax": n_iter * (4 + 1)}
    if counts != want:
        raise AssertionError(f"digits launches {counts}, expected {want}")
    if not (all(math.isfinite(v) for v in val) and val[-1] < val[0]):
        raise AssertionError(f"digits val loss did not fall: {val}")
    # the same run on the CPU (plain versions) from the same seed
    ref, _ = run_digits("cpu", "cpu", 2)
    for i, (g, w) in enumerate(zip(val, ref)):
        if abs(g - w) > 1e-4 * max(1.0, abs(w)):
            raise AssertionError(f"digits iteration {i + 1}: card val loss "
                                 f"{g} vs CPU {w}")
    log(f"[digits] CPU reference val loss {ref} agrees within 1e-4")
    return counts, val, wall


# ------------------------------------------------------------ phase 5

class EagerGraph:
    """Stands in for ``graphs.CapturedGraph`` in a module that captures a
    loop (``eager_graphs``): every replay calls the step, so the same
    loop runs eagerly on the card."""

    def __init__(self, fn, tag="graph"):
        self.fn, self.output = fn, None

    def replay(self):
        self.output = self.fn()
        return self.output


@contextlib.contextmanager
def eager_graphs(module):
    """Within the block, ``module``'s captured loop runs its step
    eagerly at every position: the eager loop on the card that the
    captured one is held to and timed against."""
    saved = module.CapturedGraph
    clear = getattr(module, "clear_cache", lambda: None)
    clear()                # no cached graph may replay in an eager loop
    module.CapturedGraph = EagerGraph
    try:
        yield
    finally:
        module.CapturedGraph = saved
        clear()


def eager_train(torch, loss_fn, params, cfg, x, y, warm, steps):
    """The eager loop a captured training step is held to, written here
    from the same ``loss_fn``: copies of ``params``, a fresh
    ``torch.optim.SGD`` at the config's rates, and per step zero_grad,
    loss, backward, step. ``warm`` untimed steps, then ``steps`` timed.
    Returns (losses, params, ms per timed step, peak GiB above the
    memory in use before the copies)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    opt = torch.optim.SGD(list(p.values()), lr=cfg.learning_rate,
                          momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(p, x, y)
        loss.backward()
        opt.step()
        return loss.detach()
    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    opt.zero_grad(set_to_none=True)
    return torch.stack(losses).float().cpu(), p, ms, peak


def hold_captured(name, torch, got_losses, want_losses, got_params,
                  want_params):
    """Captured steps against the eager loop from equal parameters: every
    loss and every final parameter bit for bit (each model's step is
    deterministic: split-K partials summed in a fixed order, col2im and
    the pool backward as gathers)."""
    got_losses = torch.as_tensor(got_losses).float().cpu()
    if not (torch.equal(got_losses, want_losses) and all(
            torch.equal(got_params[k].detach(), want_params[k].detach())
            for k in want_params)):
        raise AssertionError(f"{name}: captured steps differ from the "
                             f"eager loop (losses {got_losses.tolist()} vs "
                             f"{want_losses.tolist()})")
    return True


def phase_wide(torch, ops, gen, steps=5, width=8192, batch=8192):
    """The trainer's captured steps on the (8192,)×4 bf16 MLP, beside
    the eager loop from the same parameters (bit-equal losses and
    parameters); launches counted over the captured run."""
    from lua_mapreduce_tpu_torch.models.mlp import (flops_per_example,
                                                    init_mlp, nll_loss)
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    from lua_mapreduce_tpu_torch.utils import roofline
    sizes = (width,) * 4
    params = init_mlp(0, sizes, torch.bfloat16, "cuda")
    x = torch.randn((batch, width), device="cuda", generator=gen).to(
        torch.bfloat16)
    y = torch.randint(0, width, (batch,), device="cuda", generator=gen)
    cfg = TrainConfig(batch_size=batch)
    e_losses, e_params, e_ms, e_peak = eager_train(
        torch, nll_loss, params, cfg, x, y, 1, steps - 1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = DataParallelTrainer(nll_loss, params, cfg, device="cuda")
    del params
    first = tr.step(x, y)           # the eager warm-up step, the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = tr.run_steps(x, y, steps - 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    losses = [first] + [float(v) for v in losses]
    equal = hold_captured("wide", torch, losses, e_losses, tr.params,
                          e_params)
    imgs = (steps - 1) * batch / dt
    model_flops = (steps - 1) * batch * flops_per_example(sizes)
    tflops = model_flops / dt / 1e12
    mfu = roofline.mfu(model_flops, dt)
    log(f"[wide] mlp {'x'.join(map(str, sizes))} bf16 batch={batch}: "
        f"losses {losses}, equal to the eager loop's bit for bit")
    log(f"[wide] {steps - 1} timed captured steps in {dt * 1e3:.3f} ms "
        f"({dt * 1e3 / (steps - 1):.3f} ms/step; eager loop {e_ms:.3f} "
        f"ms/step): {imgs:.1f} images/s, {tflops:.3f} model TFLOP/s "
        f"(MFU {100 * mfu:.2f}% of the {peaks()[0] / 1e12:g} TFLOP/s "
        f"bf16 dense peak); peak {peak:.2f} GiB (eager {e_peak:.2f}); "
        f"launches {counts}")
    want = {**dict.fromkeys(ops.KERNELS, 0), "matmul_bf16": steps * 8,
            "rowwise_softmax": steps}
    if counts != want:
        raise AssertionError(f"wide launches {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"wide trainer loss not finite: {losses}")
    return counts, {"images_per_s": imgs, "model_tflops": tflops,
                    "mfu": mfu,
                    "step_ms": dt * 1e3 / (steps - 1),
                    "eager_step_ms": e_ms, "peak_mem_gib": peak,
                    "eager_peak_mem_gib": e_peak, "captures": tr.traces,
                    "equal_to_eager": equal, "losses": losses}


# ------------------------------------------------------------ phase 6

def serve_counts(n_layers, n_new, quantized):
    """Launches of one greedy_decode(use_prefill=True), from the code:
    one flash call per layer in prefill; one decode call per layer in
    each of the n_new - 1 steps after it; under quantize_lm four q8
    projections per layer (qkv, out, ff1, ff2) and the head, in prefill
    and in every step."""
    from lua_mapreduce_tpu_torch.ops import KERNELS
    return {**dict.fromkeys(KERNELS, 0),
            "flash_fwd": n_layers, "decode": n_layers * (n_new - 1),
            "q8": (4 * n_layers + 1) * n_new if quantized else 0}


def kernel_profile(torch, fn):
    """Device time (ms) and launches by kernel name of one call of
    ``fn`` under torch.profiler, largest first. The profiler warms up on
    a first call and records the second. A window's first kernels can go
    missing from the trace, so each call is preceded by 50 ms on the
    host and a spin of about 50 ms on the card, waited for, that is left
    out of the rows: what goes missing is the spin, and the window holds
    the whole call. Kernels replayed from a CUDA graph are listed one by
    one. Operator rows and the step's own annotation (``ProfilerStep*``)
    are left out: they repeat their kernels' device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(0.05)
            torch.cuda._sleep(100_000_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            prof.step()
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")
                   and "spin_kernel" not in e.key),
                  key=lambda r: -r[1])


def whole_profile(torch, fn, launches_of, want, what, attempts=3):
    """``kernel_profile`` of ``fn`` whose trace lists the port launches
    ``want`` (``launches_of`` reads them from the rows). A trace can
    still lose records: identical calls of the serving path list a few
    kernels more or fewer, and one trace lost the first three layers of
    a prefill. A lost record is a fault of the trace, a launch credited
    that did not run is one of the code, and only the first goes away
    on a new trace: the call is profiled again, at most ``attempts``
    times, and it fails if no trace lists ``want``. Returns the rows and
    the number of traces taken."""
    seen_all = []
    for i in range(attempts):
        kernels = kernel_profile(torch, fn)
        seen = launches_of(kernels)
        if seen == want:
            return kernels, i + 1
        seen_all.append(seen)
        log(f"[profile] {what}: trace {i + 1} lists port launches {seen} "
            f"of {sum(r[2] for r in kernels)} kernels, not {want}")
    raise AssertionError(f"{what}: no trace of {attempts} lists the port "
                         f"launches {want}: {seen_all}")


def port_launches_seen(kernels):
    """Launches of the serving path's port kernels in a ``kernel_profile``
    listing, by ``ops`` count name: the kernel each wrapper call launches
    (a decode call's combine left out; a q8 call is one launch)."""
    names = {"flash_fwd": ("flash_wgmma_kernel", "flash_bf16_kernel",
                           "flash_f32_kernel"),
             "decode": ("decode_split_kernel",),
             "q8": ("gv::gemv_kernel", "mk::mma_kernel",
                    "wgmma_gemm_kernel")}
    return {k: sum(r[2] for r in kernels if any(t in r[0] for t in tags))
            for k, tags in names.items()}


def gemv_per_step(kernels, pre_kernels, n_new):
    """The q8 GEMV's device ms and launches per decode step, from the
    ``kernel_profile`` rows of a greedy_decode call and of its prefill.
    Fails if a trace lists a q8 kernel that is neither the GEMV nor a
    prefill GEMM (a split's second launch)."""
    for name, _, _ in kernels:
        if "gv::" in name and "gv::gemv_kernel" not in name:
            raise AssertionError(f"q8 launched a second kernel: {name}")

    def total(rows, i):
        return sum(r[i] for r in rows if "gv::gemv_kernel" in r[0])
    return ((total(kernels, 1) - total(pre_kernels, 1)) / (n_new - 1),
            (total(kernels, 2) - total(pre_kernels, 2)) / (n_new - 1))


def phase_serving(torch, ops, seed=0):
    """The serving path at bench_decode's full width, bf16 then int8
    weights + int8 KV cache, through greedy_decode's captured loop.
    Counts are zeroed just before each timed greedy_decode and read just
    after (replays credited). The decode tail on the host clock is given
    with and without the step's capture, beside the same loop run
    eagerly on the card (``eager_graphs``; same tokens). A profiled
    repeat gives the kernel time and the kernel launches per step."""
    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(**SERVE)
    params = tt.init_transformer(seed, cfg, dtype=torch.bfloat16,
                                 device="cuda")
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(seed + 1)
                           ).cuda()
    b, p_len, n_new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    out = {}
    for tag, quantized in (("bf16", False), ("int8", True)):
        p = tt.quantize_lm(params) if quantized else params
        kw = dict(cfg=cfg, use_prefill=True, kv_q8=quantized)
        tt.greedy_decode(p, prompt, 3, **kw)               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        graphs.reset_captures()
        t0 = time.perf_counter()
        toks = tt.greedy_decode(p, prompt, n_new, **kw)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        counts = ops.launch_counts()
        n_captures, last = graphs.captures()
        if n_captures != 1:
            raise AssertionError(f"serving {tag}: {n_captures} captures, "
                                 f"expected one")
        capture_ms = last[1]
        want = serve_counts(cfg.n_layers, n_new, quantized)
        if counts != want:
            raise AssertionError(f"serving {tag} launches {counts}, "
                                 f"expected {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with eager_graphs(tt):
            tt.greedy_decode(p, prompt, 3, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager = tt.greedy_decode(p, prompt, n_new, **kw)
            torch.cuda.synchronize()
            e2e_eager = time.perf_counter() - t0
        if not torch.equal(eager, toks):
            raise AssertionError(f"serving {tag}: captured tokens differ "
                                 f"from the eager loop's")
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tt.prefill(p, prompt, cfg=cfg, total=p_len + n_new)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
        prefill_s = min(pre)
        tail = e2e - prefill_s
        toks = toks.cpu()
        if toks.shape != (b, p_len + n_new) or \
                not torch.equal(toks[:, :p_len], prompt.cpu().int()) or \
                int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"serving {tag}: bad output {toks.shape}")
        # the launches credited per replay against the port kernels the
        # trace lists (one per wrapper call, a combine or reduce aside)
        want_seen = {k: want[k] for k in port_launches_seen([])}
        want_pre = {k: serve_counts(cfg.n_layers, 1, quantized)[k]
                    for k in want_seen}
        kernels, tries = whole_profile(
            torch, lambda: tt.greedy_decode(p, prompt, n_new, **kw),
            port_launches_seen, want_seen, f"serving {tag}")
        pre_kernels, pre_tries = whole_profile(
            torch, lambda: tt.prefill(p, prompt, cfg=cfg,
                                      total=p_len + n_new),
            port_launches_seen, want_pre, f"serving {tag} prefill")
        seen = want_seen
        step_ms = (sum(k[1] for k in kernels)
                   - sum(k[1] for k in pre_kernels)) / (n_new - 1)
        step_launches = (sum(k[2] for k in kernels)
                         - sum(k[2] for k in pre_kernels)) / (n_new - 1)
        gemv_ms, gemv_launches = gemv_per_step(kernels, pre_kernels,
                                               n_new)
        replay_ms = (tail * 1e3 - capture_ms) / (n_new - 1)
        eager_ms = (e2e_eager - prefill_s) * 1e3 / (n_new - 1)
        r = {"prefill_ms": prefill_s * 1e3, "e2e_ms": e2e * 1e3,
             "decode_tail_ms": tail * 1e3,
             "decode_step_ms": tail * 1e3 / (n_new - 1),
             "capture_ms": capture_ms,
             "decode_step_ms_without_capture": replay_ms,
             "eager_decode_step_ms": eager_ms,
             "decode_tail_tokens_per_s": b * (n_new - 1) / tail,
             "decode_tokens_per_s_without_capture": b / replay_ms * 1e3,
             "eager_decode_tokens_per_s": b / eager_ms * 1e3,
             "e2e_tokens_per_s": b * n_new / e2e,
             "prefill_tokens_per_s": b * p_len / prefill_s,
             "peak_mem_gib": peak,
             "step_kernel_ms": step_ms, "step_kernel_launches": step_launches,
             "step_q8_gemv_ms": gemv_ms,
             "step_q8_gemv_launches": gemv_launches,
             "device_idle_share": 1 - step_ms / replay_ms,
             "eager_device_idle_share": 1 - step_ms / eager_ms,
             "traced_port_launches": seen,
             "profile_traces": {"call": tries, "prefill": pre_tries},
             "profiled_kernels": sum(k[2] for k in kernels),
             "top_kernels": kernels[:12],
             "launches": counts, "first_tokens": toks[0, p_len:p_len + 8]
             .tolist()}
        log(f"[serving] {tag}: prefill {r['prefill_ms']:.3f} ms "
            f"({r['prefill_tokens_per_s']:.1f} prompt tokens/s), decode "
            f"tail {r['decode_tail_ms']:.3f} ms = {r['decode_step_ms']:.4f} "
            f"ms/step ({r['decode_tail_tokens_per_s']:.1f} tokens/s) with "
            f"the step's capture ({capture_ms:.3f} ms), {replay_ms:.4f} "
            f"ms/step ({r['decode_tokens_per_s_without_capture']:.1f} "
            f"tokens/s) without it; the eager loop {eager_ms:.4f} ms/step "
            f"({r['eager_decode_tokens_per_s']:.1f} tokens/s, same tokens); "
            f"end to end {r['e2e_ms']:.3f} ms ({r['e2e_tokens_per_s']:.1f} "
            f"tokens/s); launches {counts}")
        log(f"[serving] {tag}: per decode step {step_ms:.4f} ms of kernels "
            f"over {step_launches:.1f} kernel launches (the q8 GEMV "
            f"{gemv_ms:.4f} ms over {gemv_launches:.1f}); device idle "
            f"{100 * r['device_idle_share']:.1f}% of a captured step, "
            f"{100 * r['eager_device_idle_share']:.1f}% of an eager one")
        for name, ms, n in kernels[:12]:
            log(f"[serving] {tag}   {ms:10.3f} ms {n:6d}x  {name[:90]}")
        out[tag] = r
        del p
    return out


# ------------------------------------------------------------ phase 7

def phase_serving_check(torch, ops, seed=3):
    """The serving widths at 2 layers in f32: greedy tokens on the card
    (kernels) equal the CPU's (plain versions); prefill equals the
    position scan on the card. With int8 weights and an int8 KV cache
    the card's prefill logits agree with the CPU's within the q8 op
    tolerance (the kernel rounds x to bf16, the plain version does
    not), and the greedy run is held step by step against a CPU run
    that rounds x as the kernel does (``int8_divergence``)."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(**{**SERVE, "n_layers": 2})
    p_len, n_new, b = 256, 32, SERVE_BATCH
    p_cpu = tt.init_transformer(seed, cfg, device="cpu")
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    prompt = torch.randint(0, cfg.vocab, (b, p_len),
                           generator=torch.Generator().manual_seed(seed + 1))
    want = tt.greedy_decode(p_cpu, prompt, n_new, cfg=cfg, use_prefill=True)
    ops.reset_launch_counts()
    got = tt.greedy_decode(p_gpu, prompt.cuda(), n_new, cfg=cfg,
                           use_prefill=True).cpu()
    counts = ops.launch_counts()
    if counts != serve_counts(cfg.n_layers, n_new, False):
        raise AssertionError(f"serving check launches {counts}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"serving check: {bad} greedy tokens on the "
                             f"card differ from the CPU run")
    scan = tt.greedy_decode(p_gpu, prompt.cuda(), n_new, cfg=cfg,
                            use_prefill=False).cpu()
    if not torch.equal(scan, got):
        raise AssertionError("serving check: prefill and position-scan "
                             "decoding disagree on the card")
    log(f"[check] f32 2 layers, prompt {p_len}, {n_new} new: card tokens "
        f"== CPU tokens, prefill == scan on the card")

    sampled = sampled_check(torch, tt, p_gpu, prompt.cuda(), n_new, cfg,
                            got)

    # int8 weights + int8 KV cache, with the head's logits at every step
    # (read on the host, so the card's loop runs eagerly here; its tokens
    # are then held to the captured loop's)
    q_cpu = tt.quantize_lm(p_cpu)
    q_gpu = {k: v.cuda() for k, v in q_cpu.items()}
    runs = {}
    for tag, params, round_x in (("card", q_gpu, False),
                                 ("plain", q_cpu, False),
                                 ("bf16-x", q_cpu, True)):
        sink = []
        with head_logits(tt, sink, round_x), eager_graphs(tt):
            toks = tt.greedy_decode(params, prompt.to(params["tok_emb"]
                                                      .device), n_new,
                                    cfg=cfg, use_prefill=True, kv_q8=True)
        runs[tag] = (toks.cpu()[:, p_len:], torch.stack(sink, 1))
    (tg, lg), (tp, lp) = runs["card"], runs["plain"]
    captured = tt.greedy_decode(q_gpu, prompt.cuda(), n_new, cfg=cfg,
                                use_prefill=True, kv_q8=True).cpu()
    if not torch.equal(captured[:, p_len:], tg):
        raise AssertionError("serving check: the captured int8 loop's "
                             "tokens differ from the eager loop's")
    # prefill's last-position logits (the first head call) against the
    # plain versions, at the q8 op tolerance
    err = check_close("int8 prefill last logits", lg[:, 0], lp[:, 0],
                      "float32", SERVE_TOL["q8"])
    agree = {t: float((runs[t][0] == tg).float().mean())
             for t in ("plain", "bf16-x")}
    seqs = int8_divergence(tg, lg, *runs["bf16-x"])
    log(f"[check] int8 weights: prefill logits max abs err {err:.3e} "
        f"(|logits| max {float(lp.abs().max()):.3f}); int8 weights + int8 "
        f"KV greedy tokens agree with the CPU on "
        f"{100 * agree['plain']:.1f}% (plain versions) and "
        f"{100 * agree['bf16-x']:.1f}% (plain versions with x rounded to "
        f"bf16 before each q8 product, as the kernel does)")
    for i, s in enumerate(seqs):
        log(f"[check] int8 sequence {i}: first token apart "
            f"{s['first_apart']} of {n_new}; step logits through it "
            f"within {s['max_logit_diff']:.3e} of the reference"
            + (f"; there the reference's margin for its token over the "
               f"card's is {s['margin']:.3e}" if s["margin"] is not None
               else ""))
    return {"tokens_equal": True, "prefill_equals_scan": True,
            "int8_logits_max_abs_err": err, "int8_token_agreement": agree,
            "int8_sequences": seqs, "int8_captured_equals_eager": True,
            "sampled": sampled}


def sampled_check(torch, tt, params, prompt, n_new, cfg, greedy):
    """The sampled row (temperature 0.8, top_k 40, a fixed key) on the
    card: the captured loop's tokens equal the eager loop's for the same
    key, by prefill and by the position scan; every sampled token lies
    in the top 40 of the eager loop's logits at its step; top_k=1 gives
    the greedy tokens."""
    p_len = prompt.shape[1]
    kw = dict(cfg=cfg, temperature=0.8, top_k=40, key=2024)
    got = tt.greedy_decode(params, prompt, n_new, use_prefill=True,
                           **kw).cpu()
    scan = tt.greedy_decode(params, prompt, n_new, **kw).cpu()
    sink = []
    with head_logits(tt, sink, False), eager_graphs(tt):
        eager = tt.greedy_decode(params, prompt, n_new, use_prefill=True,
                                 **kw).cpu()
    logits = torch.stack(sink, 1)              # (B, n_new, vocab)
    if not (torch.equal(got, eager) and torch.equal(scan, eager)):
        raise AssertionError("sampled check: captured and eager tokens "
                             "differ for one key")
    kth = torch.topk(logits.float(), 40, dim=-1).values[..., -1]
    chosen = logits.gather(-1, eager[:, p_len:, None].long())[..., 0]
    if not bool((chosen >= kth).all()):
        raise AssertionError("sampled check: a token outside the top 40")
    one = tt.greedy_decode(params, prompt, n_new, use_prefill=True,
                           cfg=cfg, temperature=0.8, top_k=1, key=2024)
    if not torch.equal(one.cpu(), greedy):
        raise AssertionError("sampled check: top_k=1 is not greedy")
    moved = float((eager[:, p_len:] != greedy[:, p_len:]).float().mean())
    log(f"[check] sampled (temperature 0.8, top_k 40, key 2024): captured "
        f"== eager tokens on the card, prefill == scan, every token in the "
        f"top 40 of its step's logits; {100 * moved:.1f}% of tokens differ "
        f"from greedy; top_k=1 == greedy")
    return {"captured_equals_eager": True, "in_top_k": True,
            "top_k_1_is_greedy": True, "share_not_greedy": moved}


def int8_divergence(tg, lg, tr, lr):
    """Hold the card's int8 greedy run (tokens ``tg``, per-step head
    logits ``lg``) against the CPU reference (``tr``, ``lr``): in each
    sequence, through the first token where the two part (every step
    when none does) the step logits agree within INT8_LOGIT_TOL, and
    there the reference's own margin for its token over the card's is
    within it too — the two parted at a near-tie that the rounding
    differences can flip, not at a clear choice."""
    n_new = tg.shape[1]
    out = []
    for i in range(tg.shape[0]):
        apart = (tg[i] != tr[i]).nonzero()
        j = int(apart[0]) if len(apart) else n_new
        upto = min(j, n_new - 1) + 1
        diff = float((lg[i, :upto] - lr[i, :upto]).abs().max())
        margin = None
        if j < n_new:
            margin = float(lr[i, j, tr[i, j]] - lr[i, j, tg[i, j]])
        if diff > INT8_LOGIT_TOL or (margin is not None
                                     and margin > INT8_LOGIT_TOL):
            raise AssertionError(
                f"int8 serving check, sequence {i}: step logits differ by "
                f"{diff:.3e} through step {j}, reference margin {margin} "
                f"(limit {INT8_LOGIT_TOL})")
        out.append({"first_apart": j, "max_logit_diff": diff,
                    "margin": margin})
    return out


@contextlib.contextmanager
def head_logits(tt, sink, round_x):
    """Within the block, every LM-head call of ``tt`` (prefill's, then
    one per decode step) appends its last-position logits (f32, on the
    host) to ``sink``. With ``round_x``, q8 products of CPU tensors
    round x to bf16 first: the rounding point the q8 kernel has (as the
    TPU kernel does) and its plain version lacks."""
    import torch
    head, q8_matmul = tt._head, tt.q8_matmul

    def recording_head(params, x):
        out = head(params, x)
        sink.append(out[:, -1].float().cpu())
        return out

    def q8_bf16_x(x, q, s):
        if not x.is_cuda:
            x = x.to(torch.bfloat16).to(x.dtype)
        return q8_matmul(x, q, s)
    tt._head = recording_head
    if round_x:
        tt.q8_matmul = q8_bf16_x
    try:
        yield
    finally:
        tt._head, tt.q8_matmul = head, q8_matmul


# ------------------------------------------------- conv paths (phases 2, 3, 8, 9)

def conv_model(name, dtype, device, input_shape=None, seed=0):
    """(loss_fn, params, input shape, classes, model FLOPs per example,
    kernel launches per trainer step) of one conv configuration.

    Launches per step, from the code: every conv runs one forward
    product and, in the backward, dB = patchesᵀ·g and dA = g·Wᵀ — all
    but the first conv, whose input needs no gradient; every
    ``maxpool2d`` launches the pool kernel once (its backward is plain
    autograd); the output runs one log_softmax."""
    import torch
    from lua_mapreduce_tpu_torch.models import lenet, resnet
    mm = "matmul_f32" if dtype == torch.float32 else "matmul_bf16"
    if name == "lenet5_cifar":
        shape = tuple(input_shape or lenet.CIFAR_SHAPE)
        params = lenet.init_lenet(seed, shape, dtype, device)
        n_conv, n_pool = len(lenet._CONVS), len(lenet._CONVS)
        return (lenet.nll_loss, params, shape, lenet.N_CLASSES,
                lenet.flops_per_example(shape),
                {mm: 3 * n_conv - 1, "pool": n_pool, "rowwise_softmax": 1})
    cfg = resnet.ResNetConfig.imagenet18()
    if input_shape:
        cfg = resnet.ResNetConfig(input_shape=tuple(input_shape))
    params = resnet.init_resnet(seed, cfg, dtype, device)
    n_conv = 1 + sum(2 + needs_proj
                     for _p, _s, needs_proj, _i, _o in resnet._block_plan(cfg))
    return (resnet.make_loss(cfg), params, cfg.input_shape, cfg.n_classes,
            resnet.flops_per_example(cfg),
            {mm: 3 * n_conv - 1, "pool": int(cfg.imagenet_stem),
             "rowwise_softmax": 1})


def conv_cases():
    """Every conv of the two conv configurations, as (label, batch, h, w,
    c_in, c_out, k, stride, padding, needs dA), identical shapes merged
    (the label counts them)."""
    from lua_mapreduce_tpu_torch.models import lenet, resnet
    (_, lb, _), (_, rb, _) = CONV_RUNS
    cases = {}

    def add(label, *shape):
        key = shape
        if key in cases:
            cases[key][1] += 1
        else:
            cases[key] = [label, 1]
    h, c_in = lenet.CIFAR_SHAPE[0], lenet.CIFAR_SHAPE[2]
    for i, (name, k, c_out) in enumerate(lenet._CONVS):
        add(f"lenet {name}", lb, h, h, c_in, c_out, k, 1, "VALID", i > 0)
        h, c_in = (h - k + 1) // 2, c_out
    cfg = resnet.ResNetConfig.imagenet18()
    h = cfg.input_shape[0]
    add("resnet stem", rb, h, h, cfg.input_shape[2], cfg.widths[0], 7, 2,
        "SAME", False)
    h = -(-h // 4)                          # 7x7/2 conv, 3x3/2 pool
    for p, stride, needs_proj, c_in, c_out in resnet._block_plan(cfg):
        ho = -(-h // stride)
        add(f"resnet {p} conv1", rb, h, h, c_in, c_out, 3, stride, "SAME",
            True)
        add(f"resnet {p} conv2", rb, ho, ho, c_out, c_out, 3, 1, "SAME",
            True)
        if needs_proj:
            add(f"resnet {p} proj", rb, h, h, c_in, c_out, 1, stride,
                "SAME", True)
        h = ho
    return [(label, n, *shape) for shape, (label, n) in cases.items()]


def conv_products(config):
    """The matmul products of one trainer step of a conv configuration
    ("lenet" or "resnet"), as (M, K, N, times per step, A's strides, B's
    strides): every conv's forward patches·W, dA = g·Wᵀ (all but the
    first conv) and dB = patchesᵀ·g, with the strides of the views the
    autograd Function passes (g and W are contiguous; the patch matrix's
    rows lie at ``ops.conv.patch_pitch``)."""
    from lua_mapreduce_tpu_torch.ops.conv import _norm_padding, patch_pitch
    out = []
    for label, mult, n, h, w, c_in, c_out, k, s, padding, with_da in \
            conv_cases():
        if not label.startswith(config):
            continue
        ph, pw = _norm_padding(padding, k, k, h, w, s, s)
        m = n * ((h + sum(ph) - k) // s + 1) * ((w + sum(pw) - k) // s + 1)
        kk = k * k * c_in
        pitch = patch_pitch(kk)
        out.append((m, kk, c_out, mult, (pitch, 1), (c_out, 1)))
        if with_da:
            out.append((m, c_out, kk, mult, (c_out, 1), (1, c_out)))
        out.append((kk, m, c_out, mult, (1, pitch), (c_out, 1)))
    return out


def matmul_slab(m, k, n, dtype_name, a_strides, b_strides, a_ptr=256,
                b_ptr=256):
    """The f32 partials of that product's slab split (0: unsplit, or
    its cluster sums the split in the kernel): a slab split also
    launches the split-K reduce."""
    from lua_mapreduce_tpu_torch.ops import _build
    return int(_build.library("matmul").lmr_matmul_slab(
        a_ptr, b_ptr, m, n, k, *a_strides, *b_strides,
        0 if dtype_name == "float32" else 1))


def phase_conv_kernels(torch, gen):
    """The pool kernel at the conv paths' calls, and the matmul kernel
    at every product of their conv steps, bf16, against the plain
    versions; each conv also once through cuDNN (``F.conv2d``, a
    yardstick only: the port never calls it)."""
    import torch.nn.functional as F
    from lua_mapreduce_tpu_torch import ops
    from lua_mapreduce_tpu_torch.ops.conv import (_norm_padding, _pad_hw,
                                                  patch_pitch)
    from lua_mapreduce_tpu_torch.ops.matmul import (matmul_cuda,
                                                    matmul_kernel_plan,
                                                    matmul_plain)
    from lua_mapreduce_tpu_torch.ops.pool import (_pool_plain, pool_cuda,
                                                  pool_kernel_plan)
    rows = []
    bf16 = torch.bfloat16

    # ---- pool: LeNet's two 2x2 max pools, the stem's 3x3/2 max pool at
    # its real input (the (32, 112, 112, 64) relu output with its -inf
    # border, 114 x 114), and one 2x2 avg row (no caller on the main
    # path); each with the branch of csrc/pool.cu it must take
    for label, shape, window, mode, border, branch in (
            ("lenet pool1", (1024, 28, 28, 6), 2, "max", False,
             "general/w2"),
            ("lenet pool2", (1024, 10, 10, 16), 2, "max", False,
             "vector/w8"),
            ("resnet stem pool, -inf border", (32, 112, 112, 64), 3, "max",
             True, "vector/w8"),
            ("avg (no main-path caller)", (32, 56, 56, 64), 2, "avg",
             False, "vector/w8")):
        x = torch.randn(shape, device="cuda", generator=gen).to(bf16)
        if border:          # relu output padded with -inf, as _stem does
            x = _pad_hw(torch.relu(x), (1, 1), (1, 1), value=-math.inf)
        win, st = (window, window), (2, 2)
        took = pool_kernel_plan(x, win, st).name
        if took != branch:
            raise AssertionError(f"pool {label} took the {took} branch, "
                                 f"expected {branch}")

        def run(x=x, win=win, st=st, mode=mode):
            return pool_cuda(x, win, st, mode)

        def plain(x=x, win=win, st=st, mode=mode):
            return _pool_plain(x, win, st, mode)
        xl = x.permute(0, 3, 1, 2)          # NCHW view, channels-last

        def lib(xl=xl, win=win, st=st, mode=mode):
            fn = F.max_pool2d if mode == "max" else F.avg_pool2d
            return fn(xl, win, st)
        got, want = run(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"pool {label}: non-finite output")
        if not torch.equal(run(), got):
            raise AssertionError(f"pool {label}: two calls differ")
        if mode == "max":
            err = check_close(f"pool {label}", got, want, "bfloat16", (0, 0))
        else:
            err = check_close(f"pool {label}", got, want, "bfloat16",
                              norm_tol=NORM_TOL)
        rel = norm_err(got, want)
        n_out = got.numel()
        del got, want
        nbytes = (x.numel() + n_out) * x.element_size()
        flops = n_out * win[0] * win[1]
        rows.append({**serving_row(torch, "pool", f"pool {label} "
                                   f"{tuple(x.shape)} {win[0]}x{win[1]}/2 "
                                   f"{mode} bfloat16", err, run, plain, lib,
                                   flops, nbytes, PEAK_F32_FLOPS, rel),
                     "branch": took})
        del x, xl
    torch.cuda.empty_cache()

    # ---- matmul: forward, dA = g·Wᵀ and dB = patchesᵀ·g of every conv,
    # with the strided views the autograd Function passes
    for label, mult, n, h, w, c_in, c_out, k, s, padding, with_da in \
            conv_cases():
        if mult > 1:
            label = f"{label} (x{mult})"
        ph, pw = _norm_padding(padding, k, k, h, w, s, s)
        ho = (h + sum(ph) - k) // s + 1
        wo = (w + sum(pw) - k) // s + 1
        m, kk = n * ho * wo, k * k * c_in
        scale = kk ** -0.25
        # the patch matrix at its row pitch, as ops.conv writes it
        a = (torch.randn((m, patch_pitch(kk)), device="cuda", generator=gen)
             * scale).to(bf16)[:, :kk]
        wt = (torch.randn((kk, c_out), device="cuda", generator=gen)
              * scale).to(bf16)
        g = (torch.randn((m, c_out), device="cuda", generator=gen)
             * m ** -0.25).to(bf16)
        prods = [("fwd", a, wt)]
        if with_da:
            prods.append(("dA", g, wt.t()))
        prods.append(("dB", a.t(), g))
        # the conv itself through cuDNN, on channels-last NCHW views
        xc = torch.randn((n, h, w, c_in), device="cuda",
                         generator=gen).to(bf16)
        w4 = wt.reshape(k, k, c_in, c_out)
        xl = _pad_hw(xc, ph, pw).permute(0, 3, 1, 2)
        wl = w4.permute(3, 2, 0, 1)
        conv_ms = time_ms(lambda: F.conv2d(xl, wl, stride=s), torch)
        # the yardstick computes the op that the products make up
        check_close(f"conv {label} (port vs cuDNN)",
                    ops.conv2d(xc, w4, stride=s, padding=padding),
                    F.conv2d(xl, wl, stride=s).permute(0, 2, 3, 1),
                    "bfloat16", norm_tol=NORM_TOL)
        del xc, xl, wl, w4
        for part, pa, pb in prods:
            mm_, kk_ = pa.shape
            nn_ = pb.shape[1]
            got = matmul_cuda(pa, pb, bf16)
            again = matmul_cuda(pa, pb, bf16)
            want = matmul_plain(pa, pb, bf16)
            torch.cuda.synchronize()
            err = check_close(f"matmul {label} {part}", got, want,
                              "bfloat16", norm_tol=NORM_TOL)
            rel = norm_err(got, want)
            # split or not, the sum order is fixed: two calls agree bit
            # for bit
            if not torch.equal(got, again):
                raise AssertionError(f"matmul {label} {part}: two calls "
                                     f"differ")
            sweep = (conv_plan_sweep(torch, f"{label} {part}", pa, pb, want)
                     if (mm_, kk_, nn_) in SWEEP_PRODUCTS else None)
            del got, want, again
            plan = matmul_kernel_plan(pa, pb)
            bms, by = bound(2 * mm_ * nn_ * kk_,
                            (mm_ * kk_ + kk_ * nn_ + mm_ * nn_) * 2,
                            peaks()[0])
            row = {"kernel": "matmul_bf16",
                   "case": f"matmul conv {label} {part} ({mm_},{kk_})x"
                           f"({kk_},{nn_}) bfloat16",
                   "conv_config": label.split()[0], "per_step": mult,
                   "splits": plan.splits,
                   "plan": {k_: v for k_, v in plan._asdict().items()
                            if v is not None},
                   "max_abs_err": err, "norm_err": rel,
                   "ms": time_ms(lambda: matmul_cuda(pa, pb, bf16), torch),
                   "plain_ms": time_ms(lambda: matmul_plain(pa, pb, bf16),
                                       torch),
                   "library_ms": time_ms(lambda: torch.matmul(pa, pb),
                                         torch),
                   "bound_ms": bms, "bound_by": by}
            if part == "fwd":
                row["cudnn_conv_ms"] = conv_ms
            if sweep:
                row["plan_sweep_ms"] = sweep
            rows.append(row)
        del a, wt, g, prods
        torch.cuda.empty_cache()
    return rows


# the two conv products whose plans phase 2 times against the others,
# as (M, K, N): ResNet's first-stage weight gradient (K of 100,352: a
# split of a 64-wide tile) and its last stage's 3×3 forward (1,568 × 512
# outputs over K of 4,608: too few tiles for the SMs)
SWEEP_PRODUCTS = ((576, 100352, 64), (1568, 4608, 512))


def conv_plan_sweep(torch, label, a, b, want):
    """A product at the wgmma kernel's plans (tile widths, unsplit with
    either epilogue, splits as a cluster or a slab), each held to the
    plain version ``want``: device ms by plan."""
    from lua_mapreduce_tpu_torch.ops.matmul import (WG_MAX_CLUSTER,
                                                    matmul_forced,
                                                    matmul_kernel_plan)
    m, k = a.shape
    n = b.shape[1]
    plan = matmul_kernel_plan(a, b)
    units = -(-k // 64)
    times = {}
    for bn in (64, 128, 256):
        if (n <= 64 and bn > 64) or (n <= 128 and bn > 128):
            continue
        for s in sorted({1, 2, 3, 4, 5, 6, 8, 16, plan.splits}):
            chunk = -(-units // s)
            if s > units or -(-units // chunk) != s:
                continue
            kinds = ([(1, "regs")] + ([(1, "tma")] if bn <= 128 else [])
                     if s == 1 else
                     [(1, "regs")] + ([(s, "regs")] if s <= WG_MAX_CLUSTER
                                      else []))
            for cl, epi in kinds:
                tag = (f"128x{bn}/s{s}/"
                       f"{'cluster' if cl > 1 else 'slab' if s > 1 else epi}")
                got = matmul_forced(a, b, torch.bfloat16, bn, s, cl, epi)
                check_close(f"sweep {label} {tag}", got, want, "bfloat16",
                            norm_tol=NORM_TOL)
                times[tag] = time_ms(
                    lambda: matmul_forced(a, b, torch.bfloat16, bn, s, cl,
                                          epi), torch)
    return times


def lenet_grads(torch, gen, batch=256):
    """LeNet-5 loss and parameter gradients through the kernels against
    the same model on CPU copies of the inputs and parameters (the plain
    versions), f32 and bf16 (bf16 also normwise)."""
    from lua_mapreduce_tpu_torch.models.lenet import init_lenet, nll_loss
    out = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        x = torch.rand((batch, 32, 32, 3), device="cuda",
                       generator=gen).to(dtype)
        y = torch.randint(0, 10, (batch,), device="cuda", generator=gen)
        p0 = init_lenet(1, dtype=dtype, device="cuda")
        grads = []
        for dev in ("cuda", "cpu"):
            p = {k: v.to(dev).requires_grad_(True) for k, v in p0.items()}
            loss = nll_loss(p, x.to(dev), y.to(dev))
            grads.append((loss.detach().cpu(), {
                k: g.cpu() for k, g in zip(p, torch.autograd.grad(
                    loss, list(p.values())))}))
        (lk, gk), (lp, gp) = grads
        ntol = NORM_TOL if dt == "bfloat16" else None
        err = check_close(f"lenet loss {dt}", lk.reshape(1), lp.reshape(1),
                          dt)
        rel = 0.0
        for k in gk:
            err = max(err, check_close(f"lenet grad {k} {dt}", gk[k], gp[k],
                                       dt, norm_tol=ntol))
            rel = max(rel, norm_err(gk[k], gp[k]))
        out[f"lenet {dt}"] = {"max_abs_err": err, "max_norm_err": rel}
        log(f"[grads] lenet {dt} batch={batch}: loss kernel={float(lk):.6f} "
            f"plain={float(lp):.6f} max_abs_err={err:.3e} "
            f"max normwise {rel:.3e}")
    return out


def phase_conv(torch, ops, gen):
    """bench_conv_train's two configurations through the trainer's
    captured ``run_steps``, bf16, beside the eager loop from the same
    parameters (LeNet bit for bit, ResNet within the conv check's
    limits): counts zeroed just before the timed run_steps and read just
    after; a profiled one-step repeat gives each step's device time by
    kernel."""
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    from lua_mapreduce_tpu_torch.utils import roofline
    out = {}
    for name, batch, steps in CONV_RUNS:
        loss_fn, params, shape, n_cls, per_ex, per_step = conv_model(
            name, torch.bfloat16, "cuda")
        x = torch.randn((batch, *shape), device="cuda", generator=gen).to(
            torch.bfloat16)
        y = torch.randint(0, n_cls, (batch,), device="cuda", generator=gen)
        cfg = TrainConfig(batch_size=batch)
        e_losses, e_params, e_ms, e_peak = eager_train(
            torch, loss_fn, params, cfg, x, y, 4, steps)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = DataParallelTrainer(loss_fn, params, cfg, device="cuda")
        del params
        first = tr.step(x, y)           # the eager warm-up step, the capture
        warm = tr.run_steps(x, y, 3)    # the host's first calls run slower
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = tr.run_steps(x, y, steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = {**dict.fromkeys(ops.KERNELS, 0),
                **{k: steps * v for k, v in per_step.items()}}
        if counts != want:
            raise AssertionError(f"{name} launches {counts}, expected {want}")
        losses = [first] + [float(v) for v in torch.cat([warm, losses])]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name} loss not finite: {losses}")
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        equal = hold_captured(name, torch, losses, e_losses, tr.params,
                              e_params)
        del e_params
        # a matmul_bf16 call launches the general kernel or the wgmma
        # one, and a split product also the split-K reduce
        tags = (("matmul_bf16", ("bf16k::matmul_bf16_kernel",
                                 "wgmma_gemm_kernel")),
                ("matmul_splitk_reduce", ("splitk_reduce_kernel",)),
                ("pool", ("pool_kernel",)),
                ("rowwise_softmax", ("softmax_warp_kernel",
                                     "softmax_regs_kernel",
                                     "softmax_stream_kernel")))
        # the trace is whole if it lists every launch the step makes
        # (a slab split's; a cluster split sums in the kernel)
        want_seen = {**per_step, "matmul_splitk_reduce": sum(
            mult for m_, k_, n_, mult, sa, sb in conv_products(
                name.split("_")[0].rstrip("0123456789"))
            if matmul_slab(m_, k_, n_, "bfloat16", sa, sb) > 0)}
        kernels, tries = whole_profile(
            torch, lambda: tr.run_steps(x, y, 1),
            lambda ks: {k: sum(r[2] for r in ks
                               if any(t in r[0] for t in tag))
                        for k, tag in tags},
            want_seen, f"{name} step")
        seen, complete = want_seen, True
        dev_ms = sum(k[1] for k in kernels)
        port_ms = {k: sum(r[1] for r in kernels if any(t in r[0] for t in tag))
                   for k, tag in tags}
        step_ms = dt * 1e3 / steps
        imgs = batch * steps / dt
        model_flops = batch * steps * per_ex
        tflops = model_flops / dt / 1e12
        r = {"batch": batch, "steps": steps, "step_ms": step_ms,
             "images_per_s": imgs, "model_tflops": tflops,
             "mfu": roofline.mfu(model_flops, dt),
             "losses": losses, "launches": counts, "peak_mem_gib": peak,
             "eager_step_ms": e_ms, "eager_peak_mem_gib": e_peak,
             "equal_to_eager": equal,
             "captures": tr.traces,
             "profiled_step_device_ms": dev_ms,
             "profiled_step_kernel_ms": port_ms,
             "profiled_step_launches": seen, "profile_complete": complete,
             "profile_traces": tries,
             "device_idle_share": 1 - dev_ms / step_ms,
             "top_kernels": kernels[:12]}
        log(f"[conv] {name} b{batch} bf16: {steps} timed captured steps, "
            f"{step_ms:.3f} ms/step (the eager loop {e_ms:.3f}), {imgs:.1f} "
            f"images/s, {tflops:.4f} model TFLOP/s "
            f"(MFU {100 * r['mfu']:.4f}% of the {peaks()[0] / 1e12:g} "
            f"TFLOP/s bf16 dense peak); losses {losses}, equal to the "
            f"eager loop's bit for bit; peak {peak:.2f} GiB (eager {e_peak:.2f}); launches "
            f"{counts}")
        log(f"[conv] {name}: profiled step {dev_ms:.3f} ms on the device "
            f"(matmul kernels {port_ms['matmul_bf16']:.3f}, split-K reduce "
            f"{port_ms['matmul_splitk_reduce']:.3f}, pool "
            f"{port_ms['pool']:.3f}, log_softmax "
            f"{port_ms['rowwise_softmax']:.3f}); idle "
            f"{'' if complete else 'at most '}"
            f"{100 * r['device_idle_share']:.1f}% of the timed step; "
            f"port launches in the trace {seen}"
            f"{'' if complete else f' of {want_seen}: the trace is partial'}"
            f"; peak {peak:.2f} GiB")
        for kname, ms, cnt in kernels[:12]:
            log(f"[conv] {name}   {ms:10.3f} ms {cnt:6d}x  {kname[:90]}")
        out[name] = r
        del tr, x, y
        torch.cuda.empty_cache()
    return out


def leafwise_err(got, want):
    """Normwise ‖got − want‖ / ‖want‖ of two dicts of tensors: over all
    leaves together, and the worst leaf with its name."""
    num = {k: float((got[k].cpu() - w).norm()) ** 2 for k, w in want.items()}
    den = {k: float(w.norm()) ** 2 for k, w in want.items()}
    worst = max(want, key=lambda k: num[k] / max(den[k], 1e-60))
    return ((sum(num.values()) / sum(den.values())) ** 0.5,
            (num[worst] / max(den[worst], 1e-60)) ** 0.5, worst)


def phase_conv_check(torch, ops, seed=4):
    """Three f32 trainer steps of LeNet-5 b64 and of the ResNet-18
    ImageNet topology at 64x64 b4 on the card (kernels) and on the CPU
    (plain versions), from the same parameters and images. Each step's
    loss agrees within CONV_CHECK_RTOL; its gradient and its parameter
    update (after − before, on each side) within the model's
    CONV_CHECKS limits, over all parameters and in the worst one. LeNet
    runs free; ResNet's card parameters are set to the CPU run's before
    each step: a ReLU gradient jumps where an activation crosses zero,
    and rounding differences flip such near-ties (PERF.md §6)."""
    from lua_mapreduce_tpu_torch.train.data import make_images
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    out = {}
    for name, (batch, shape, free, lim_all, lim_leaf) in CONV_CHECKS.items():
        loss_fn, params, shape, n_cls, _, per_step = conv_model(
            name, torch.float32, "cpu", shape, seed)
        x, y, _, _ = make_images(seed, n_train=batch, n_val=1, shape=shape,
                                 n_classes=n_cls)
        cfg = TrainConfig(batch_size=batch)
        cpu = DataParallelTrainer(loss_fn, params, cfg, device="cpu")
        card = DataParallelTrainer(loss_fn, params, cfg, device="cuda")
        counts = dict.fromkeys(ops.KERNELS, 0)
        losses, gerrs, uerrs = [], [], []
        for _ in range(3):
            if not free:
                with torch.no_grad():
                    for k, v in card.params.items():
                        v.copy_(cpu.params[k])
            before = [{k: v.detach().to("cpu", copy=True)
                       for k, v in t.params.items()} for t in (cpu, card)]
            lc = cpu.step(x, y)
            ops.reset_launch_counts()
            lg = card.step(x, y)
            for k, v in ops.launch_counts().items():
                counts[k] += v
            losses.append((lg, lc))
            gerrs.append(leafwise_err(
                {k: v.grad for k, v in card.params.items()},
                {k: v.grad for k, v in cpu.params.items()}))
            uerrs.append(leafwise_err(
                {k: v.detach().cpu() - before[1][k]
                 for k, v in card.params.items()},
                {k: v.detach() - before[0][k]
                 for k, v in cpu.params.items()}))
        want = {**dict.fromkeys(ops.KERNELS, 0),
                **{k: 3 * v for k, v in per_step.items()}}
        if counts != want:
            raise AssertionError(f"conv check {name} launches {counts}, "
                                 f"expected {want}")
        rel = max(abs(g - c) / abs(c) for g, c in losses)
        fmt = " ".join(f"{a:.3e} (worst {w:.3e} in {k})"
                       for a, w, k in gerrs)
        ufmt = " ".join(f"{a:.3e} (worst {w:.3e} in {k})"
                        for a, w, k in uerrs)
        msg = (f"{name} b{batch} {shape} f32, 3 steps"
               f"{', free-running' if free else ', each from the CPU params'}"
               f": (card, CPU) losses {losses}, max relative difference "
               f"{rel:.3e} (limit {CONV_CHECK_RTOL}); gradient normwise {fmt}"
               f"; update normwise {ufmt} (limits {lim_all} over all "
               f"parameters, {lim_leaf} in the worst)")
        if rel > CONV_CHECK_RTOL or any(
                a > lim_all or w > lim_leaf for a, w, _ in gerrs + uerrs):
            raise AssertionError(f"conv check {msg}")
        log(f"[conv check] {msg}")
        out[name] = {"free_running": free, "losses_card_cpu": losses,
                     "max_rel_diff": rel, "grad_norm_err": gerrs,
                     "update_norm_err": uerrs}
    return out


# ------------------------------------ LM training path (phases 2, 10-12)

def sdpa_flash_fwd(torch, q, k, v):
    """A callable timing ``aten._scaled_dot_product_flash_attention``
    (causal; it returns the logsumexp, as the lse-mode kernel does) on
    (B, H, L, D) copies of q, k, v — a yardstick only."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    op = torch.ops.aten._scaled_dot_product_flash_attention
    return lambda: op(qt, kt, vt, 0.0, True, False)


def sdpa_flash_bwd(torch, q, k, v, do):
    """(callable, its (dq, dk, dv) in the (B, L, H, D) layout) of
    ``aten._scaled_dot_product_flash_attention_backward`` — dq, dk and
    dv in one call from a saved out and logsumexp (causal, equal q and
    kv heads, bf16; it takes no lse cotangent) — a yardstick only."""
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().to(q.dtype)
                       for x in (q, k, v, do))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    op = torch.ops.aten._scaled_dot_product_flash_attention_backward

    def run():
        return op(dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, True,
                  seed, offset)
    return run, tuple(g.transpose(1, 2) for g in run())


def flash_bwd_cases():
    """(label, B, L, H, H_kv, D, dtype, window, g_lse, kernel path) of
    the backward rows: the LM training shape and its modern GQA 4:1 form
    (random lse cotangent, as the ring's merge passes one),
    bench_flash_grad_error's shape with its 0.1·sum(lse) loss (g_lse =
    0.1), a window, the LM shape through misaligned views (the general
    kernels), and f32 rows (the check run's shape and a ragged L) held at
    1e-4. The bf16 rows of the main paths must take the TMA + wgmma
    kernels."""
    return [("LM training causal", 8, 2048, 16, 16, 64, "bfloat16", 0,
             "random", "tma"),
            ("LM training GQA 4:1 causal", 8, 2048, 16, 4, 64, "bfloat16",
             0, "random", "tma"),
            ("grad-error bench causal, lse", 2, 2048, 8, 8, 128, "bfloat16",
             0, "0.1", "tma"),
            ("window 512", 8, 2048, 16, 16, 64, "bfloat16", 512, "random",
             "tma"),
            ("LM training causal, misaligned view", 8, 2048, 16, 16, 64,
             "bfloat16", 0, "random", "general"),
            ("check-run causal", 2, 256, 16, 16, 64, "float32", 0, "random",
             "f32"),
            ("ragged L, GQA 4:1", 2, 1000, 8, 2, 128, "float32", 0,
             "random", "f32")]


def phase_flash_bwd_kernels(torch, gen):
    """The dq and dkv kernels against the plain backward
    (``flash_attention_bwd_plain``) on the same inputs: o and lse from
    the lse-mode forward kernel, a random do, an lse cotangent. f32 at
    1e-4; bf16 at the serving flash tolerance and normwise ≤ 1e-2, and
    the plain backward with the softmax scale 5% off must fail the same
    check. Bound by operations: dq 3 products (s, dp, dq), dkv 4 (s, dp,
    dv, dk), 2 FLOP per multiply-add over the visible pairs of every q
    head. The library column is SDPA's flash backward for the pair. Each
    row names the kernels it took (``flash_bwd_kernel_path``)."""
    from lua_mapreduce_tpu_torch.ops.attention import (
        flash_attention_bwd_plain, flash_attention_cuda, flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda, flash_bwd_kernel_path)
    rows = []
    for label, b, l, h, hkv, d, dt, window, gl, want_path in \
            flash_bwd_cases():
        dtype = getattr(torch, dt)

        def randn(*shape, scale=1.0, dtype=dtype):
            """A [..., 1:] view of a tensor one element wider on the
            misaligned row (base and head stride off 16 bytes: only the
            general kernels read it)."""
            wide = want_path == "general" and dtype == torch.bfloat16
            x = (torch.randn((*shape[:-1], shape[-1] + wide), device="cuda",
                             generator=gen) * scale).to(dtype)
            return x[..., 1:] if wide else x
        q = randn(b, l, h, d, scale=Q_SCALE)
        k, v = randn(b, l, hkv, d), randn(b, l, hkv, d)
        do = randn(b, l, h, d, dtype=torch.float32)
        g_lse = (randn(b, l, h, dtype=torch.float32) if gl == "random"
                 else torch.full((b, l, h), 0.1, device="cuda"))
        o, lse = flash_attention_cuda(q, k, v, causal=True, window=window,
                                      with_lse=True)
        delta = ((do * o).sum(-1) - g_lse).contiguous()
        dob = do.to(dtype)
        if want_path == "general":       # the same values, misaligned
            dob = torch.empty((b, l, h, d + 1), device="cuda",
                              dtype=dtype)[..., 1:].copy_(dob)
        path = flash_bwd_kernel_path(q, k, v, dob)
        if path != want_path:
            raise AssertionError(f"flash bwd {label}: took the {path} "
                                 f"kernels, expected {want_path}")
        kw = dict(causal=True, window=window)

        def run_dq(q=q, k=k, v=v, dob=dob, lse=lse, delta=delta, kw=kw):
            return flash_bwd_dq_cuda(q, k, v, dob, lse, delta, **kw)

        def run_dkv(q=q, k=k, v=v, dob=dob, lse=lse, delta=delta, kw=kw):
            return flash_bwd_dkv_cuda(q, k, v, dob, lse, delta, **kw)

        def plain(q=q, k=k, v=v, o=o, lse=lse, do=do, g_lse=g_lse,
                  window=window, scale=None):
            return flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                             window=window, g_lse=g_lse,
                                             scale=scale)
        dq, (dk, dv) = run_dq(), run_dkv()
        want = plain()
        torch.cuda.synchronize()
        tol = SERVE_TOL[f"flash {dt}"] if dt == "bfloat16" else (1e-4, 1e-4)
        ntol = NORM_TOL if dt == "bfloat16" else None
        wrong = plain(scale=d ** -0.5 * WRONG_SCALE)
        lib, lib_note = None, None
        if want_path == "general":
            lib_note = "n/a: SDPA's yardstick is the aligned row's"
        elif dt != "bfloat16":
            lib_note = "n/a: SDPA's flash backward takes fp16/bf16 only"
        elif window:
            lib_note = "n/a: SDPA's flash backward has no sliding window"
        elif hkv != h:
            lib_note = ("n/a: SDPA's flash backward takes equal q and kv "
                        "heads")
        else:
            lib, lib_grads = sdpa_flash_bwd(torch, q, k, v, do)
            if gl == "0.1":
                # its own out and lse, no lse cotangent: the same function
                # as the kernels' only where g_lse is 0 — held loosely
                lib_note = ("takes no lse cotangent; held against the "
                            "kernels at g_lse = 0")
                z = ((do * o).sum(-1)).contiguous()
                ref = (flash_bwd_dq_cuda(q, k, v, dob, lse, z, **kw),
                       *flash_bwd_dkv_cuda(q, k, v, dob, lse, z, **kw))
                lib_rel = max(norm_err(a, r) for a, r in zip(lib_grads, ref))
                if lib_rel > 5e-2:
                    raise AssertionError(f"flash bwd {label}: SDPA's "
                                         f"backward parts from the "
                                         f"kernels' by {lib_rel:.3e}")
                lib_note += f" (normwise {lib_rel:.3e})"
                del ref
            else:
                lib_note = "takes no lse cotangent"
            del lib_grads
        item = q.element_size()
        pairs = visible_pairs(l, True, window)
        in_bytes = (2 * b * l * h * d + 2 * b * l * hkv * d) * item \
            + 2 * b * l * h * 4
        peak = peaks()[0] if dt == "bfloat16" else PEAK_F32_FLOPS
        for kernel, parts, fn, n_prod, out_bytes in (
                ("flash_bwd_dq", (("dq", dq, want[0]),), run_dq, 3,
                 b * l * h * d * item),
                ("flash_bwd_dkv", (("dk", dk, want[1]), ("dv", dv, want[2])),
                 run_dkv, 4, 2 * b * l * hkv * d * item)):
            err, rel, control = 0.0, 0.0, 0.0
            for name, got, w in parts:
                err = max(err, check_close(f"{kernel} {label} {name}", got,
                                           w, dt, tol, ntol))
                rel = max(rel, norm_err(got, w))
                bad = wrong[("dq", "dk", "dv").index(name)]
                control = max(control, assert_rejects(
                    f"{kernel} {label} {name} (scale 5% off)", bad, w, dt,
                    tol, ntol))
            row = serving_row(
                torch, kernel, f"{kernel} {label} ({b},{l},{h}/{hkv},{d}) "
                f"{dt}", err, fn, plain, lib, 2 * n_prod * b * h * pairs * d,
                in_bytes + out_bytes, peak, rel, control)
            row["library_note"] = lib_note
            row["path"] = path
            rows.append(row)
        del q, k, v, do, o, lse, delta, dob, dq, dk, dv, want, wrong, lib
        torch.cuda.empty_cache()
    return rows


def train_counts(n_layers, steps, remat=False, accum=1):
    """Launches of ``steps`` LM train steps, from the code: per
    microbatch one lse-mode flash forward per layer (twice under remat,
    which reruns each block's forward in the backward) and one dq and
    one dkv launch per layer in the backward; nothing else of the port
    (projections, the head and the loss's log_softmax are torch)."""
    from lua_mapreduce_tpu_torch.ops import KERNELS
    per = steps * accum * n_layers
    return {**dict.fromkeys(KERNELS, 0),
            "flash_fwd": per * (2 if remat else 1),
            "flash_bwd_dq": per, "flash_bwd_dkv": per}


def lm_tokens(torch, vocab, batch, seq, seed):
    import numpy as np
    s = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))
    return torch.from_numpy(s[:, :-1]), torch.from_numpy(s[:, 1:])


def phase_lm_train(torch, ops, seed=0):
    """bench_transformer_step's MHA and modern configurations through
    ``make_train_step`` at full width, bf16, SGD with momentum: a warm-up
    step, then counts zeroed, LM_STEPS timed steps, counts read; a
    profiled repeat gives a step's device time by kernel."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    from lua_mapreduce_tpu_torch.utils import roofline
    out = {}
    for tag, extra in (("mha", {}), ("modern", LM_MODERN)):
        cfg = tt.TransformerConfig(**LM, **extra)
        params = {k: v.requires_grad_(True) for k, v in tt.init_transformer(
            seed, cfg, dtype=torch.bfloat16, device="cuda").items()}
        # optax.sgd(1e-3, momentum=0.9) (train/optim.py says how)
        step = tt.make_train_step(cfg, optim.sgd(params.values(), 1e-3,
                                                 momentum=0.9))
        tok, tgt = (x.cuda() for x in lm_tokens(torch, cfg.vocab, LM_BATCH,
                                                LM_SEQ, seed))
        first = float(step(params, tok, tgt))              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [step(params, tok, tgt) for _ in range(LM_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = train_counts(cfg.n_layers, LM_STEPS)
        if counts != want:
            raise AssertionError(f"lm train {tag} launches {counts}, "
                                 f"expected {want}")
        losses = [first] + [float(x) for x in losses]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"lm train {tag} loss not finite: {losses}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kernels = kernel_profile(torch, lambda: step(params, tok, tgt))
        dev_ms = sum(kk[1] for kk in kernels)
        # each kernel's TMA + wgmma form, or its general form
        tags = (("flash_fwd", ("wsk::flash_wgmma_kernel", "flash_bf16_kernel")),
                ("flash_bwd_dq", ("wsk::dq_wgmma_kernel", "bfk::dq_kernel")),
                ("flash_bwd_dkv", ("wsk::dkv_wgmma_kernel",
                                   "bfk::dkv_kernel")))
        port_ms = {kk: sum(r[1] for r in kernels if any(n in r[0] for n in t))
                   for kk, t in tags}
        seen = {kk: sum(r[2] for r in kernels if any(n in r[0] for n in t))
                for kk, t in tags}
        per_step = {kk: v for kk, v in train_counts(cfg.n_layers, 1).items()
                    if v}
        # the step's device time by kind: the port's kernels, cuBLAS
        # products (the projections and the head), everything else
        # (norms, activations, residual adds, the loss, the optimizer)
        by_kind = {"port": sum(port_ms.values()),
                   "cublas": sum(r[1] for r in kernels
                                 if "nvjet" in r[0] or "gemm" in r[0])}
        by_kind["other"] = dev_ms - by_kind["port"] - by_kind["cublas"]
        step_ms = dt * 1e3 / LM_STEPS
        tok_s = LM_BATCH * LM_SEQ * LM_STEPS / dt
        model_flops = (LM_BATCH * LM_SEQ * LM_STEPS
                       * tt.flops_per_token(cfg, LM_SEQ))
        tflops = model_flops / dt / 1e12
        r = {"config": f"d{cfg.d_model} h{cfg.n_heads}/{tt.kv_heads(cfg)} "
                       f"L{cfg.n_layers} ff{cfg.d_ff} v{cfg.vocab} "
                       f"seq{LM_SEQ} b{LM_BATCH} bf16"
                       + (" llama-style" if extra else ""),
             "steps": LM_STEPS, "step_ms": step_ms, "tokens_per_s": tok_s,
             "model_tflops": tflops, "mfu": roofline.mfu(model_flops, dt),
             "losses": losses, "launches": counts, "peak_mem_gib": peak,
             "profiled_step_device_ms": dev_ms,
             "profiled_step_kernel_ms": port_ms,
             "profiled_step_launches": seen,
             "profiled_step_ms_by_kind": by_kind,
             "profile_complete": seen == per_step,
             "device_idle_share": 1 - dev_ms / step_ms,
             "top_kernels": kernels[:14]}
        log(f"[lm train] {tag} {r['config']}: {LM_STEPS} timed steps, "
            f"{step_ms:.3f} ms/step, {tok_s:.1f} tokens/s, {tflops:.3f} "
            f"model TFLOP/s (MFU {100 * r['mfu']:.3f}% of the "
            f"{peaks()[0] / 1e12:g} TFLOP/s bf16 dense peak), peak "
            f"{peak:.2f} GiB; losses "
            f"{losses[0]:.4f} .. {losses[-1]:.4f}; launches {counts}")
        log(f"[lm train] {tag}: profiled step {dev_ms:.3f} ms on the device "
            f"(flash fwd {port_ms['flash_fwd']:.3f}, dq "
            f"{port_ms['flash_bwd_dq']:.3f}, dkv "
            f"{port_ms['flash_bwd_dkv']:.3f}; cuBLAS "
            f"{by_kind['cublas']:.3f}, other {by_kind['other']:.3f}); idle "
            f"{100 * r['device_idle_share']:.1f}% of the timed step; port "
            f"launches in the trace {seen}"
            f"{'' if r['profile_complete'] else ' (partial trace)'}")
        for name, ms, n in kernels[:14]:
            log(f"[lm train] {tag}   {ms:10.3f} ms {n:6d}x  {name[:90]}")
        out[tag] = r
        del params, step, tok, tgt
        torch.cuda.empty_cache()
    return out


def phase_lm_check(torch, ops, seed=5):
    """The LM widths at 2 layers in f32 (seq 256, batch 2), MHA and
    modern: three free-running train steps on the card (kernels) and on
    the CPU (plain versions) from the same parameters and tokens, SGD
    with momentum at LM_CHECK_LR. Each step's loss agrees within
    LM_CHECK_RTOL; its gradient and its parameter update (−lr·b, as the
    optimizer applies it) normwise within LM_CHECK_NORM, over all
    parameters and in the worst one. Then one
    step with remat and grad_accum=2 on the card equals the plain step
    from the same parameters, and launches flash_fwd 2·2·L times."""
    import dataclasses

    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    out = {}
    for tag, extra in (("mha", {}), ("modern", LM_MODERN)):
        cfg = tt.TransformerConfig(**{**LM, "n_layers": 2, "max_seq": 256},
                                   **extra)
        p0 = tt.init_transformer(seed, cfg, device="cpu")
        tok, tgt = lm_tokens(torch, cfg.vocab, 2, 256, seed)
        sides = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.detach().clone().to(dev).requires_grad_(True)
                 for k, v in p0.items()}
            opt = optim.sgd(p.values(), LM_CHECK_LR, momentum=0.9)
            sides[dev] = (p, tt.make_train_step(cfg, opt), opt)
        losses, gerrs, uerrs = [], [], []
        counts = dict.fromkeys(ops.KERNELS, 0)
        for _ in range(3):
            lc = float(sides["cpu"][1](sides["cpu"][0], tok, tgt))
            ops.reset_launch_counts()
            lg = float(sides["cuda"][1](sides["cuda"][0], tok, tgt))
            for k, v in ops.launch_counts().items():
                counts[k] += v
            losses.append((lg, lc))
            pc, pg = sides["cpu"][0], sides["cuda"][0]
            gerrs.append(leafwise_err({k: v.grad for k, v in pg.items()},
                                      {k: v.grad for k, v in pc.items()}))
            uerrs.append(leafwise_err(*(
                {k: -LM_CHECK_LR * sides[d][2].state[v]["momentum_buffer"]
                 for k, v in sides[d][0].items()} for d in ("cuda", "cpu"))))
        if counts != train_counts(2, 3):
            raise AssertionError(f"lm check {tag} launches {counts}")
        rel = max(abs(g - c) / abs(c) for g, c in losses)
        fmt = " ".join(f"{a:.3e} (worst {w:.3e} in {k})" for a, w, k in gerrs)
        ufmt = " ".join(f"{a:.3e} (worst {w:.3e} in {k})"
                        for a, w, k in uerrs)
        msg = (f"{tag} 2 layers f32 seq 256 b2, 3 free-running steps: "
               f"(card, CPU) losses {losses}, max relative difference "
               f"{rel:.3e} (limit {LM_CHECK_RTOL}); gradient normwise {fmt}; "
               f"update normwise {ufmt} (limit {LM_CHECK_NORM})")
        if rel > LM_CHECK_RTOL or any(a > LM_CHECK_NORM or w > LM_CHECK_NORM
                                      for a, w, _ in gerrs + uerrs):
            raise AssertionError(f"lm check {msg}")
        log(f"[lm check] {msg}")
        # remat + grad_accum=2 against the plain step, on the card
        steps = {}
        for name, c, accum in (("plain", cfg, 1),
                               ("remat+accum2",
                                dataclasses.replace(cfg, remat=True), 2)):
            p = {k: v.detach().clone().cuda().requires_grad_(True)
                 for k, v in p0.items()}
            st = tt.make_train_step(c, optim.sgd(p.values(), LM_CHECK_LR,
                                                 momentum=0.9),
                                    grad_accum=accum)
            ops.reset_launch_counts()
            loss = float(st(p, tok, tgt))
            steps[name] = (loss, {k: v.grad.cpu() for k, v in p.items()},
                           ops.launch_counts())
        (l1, g1, _), (l2, g2, c2) = steps["plain"], steps["remat+accum2"]
        want = train_counts(2, 1, remat=True, accum=2)
        if c2 != want:
            raise AssertionError(f"lm check {tag} remat+accum launches "
                                 f"{c2}, expected {want}")
        a, w, k = leafwise_err(g2, g1)
        if abs(l2 - l1) > LM_CHECK_RTOL * abs(l1) or a > LM_CHECK_NORM \
                or w > LM_CHECK_NORM:
            raise AssertionError(f"lm check {tag}: remat+accum2 step "
                                 f"loss {l2} vs {l1}, gradient normwise "
                                 f"{a:.3e} (worst {w:.3e} in {k})")
        log(f"[lm check] {tag}: remat + grad_accum=2 step equals the plain "
            f"step on the card (loss {l2:.6f} vs {l1:.6f}, gradient "
            f"normwise {a:.3e}, worst {w:.3e} in {k}); launches {c2}")
        out[tag] = {"losses_card_cpu": losses, "max_rel_diff": rel,
                    "grad_norm_err": gerrs, "update_norm_err": uerrs,
                    "remat_accum": {"loss": l2, "plain_loss": l1,
                                    "grad_norm_err": [a, w, k],
                                    "launches": c2}}
    return out


def phase_train_lm(torch, ops, steps=20):
    """The port's ``train_lm`` script at the LM widths with ``--bf16``
    (f32 masters under Adam), seq 2048, batch 8, on its synthetic stride
    task: it runs, and its last logged loss is below its first."""
    from lua_mapreduce_tpu_torch.examples.lm import train_lm
    args = train_lm.build_parser().parse_args(
        ["--steps", str(steps), "--bf16", "--seq", str(LM_SEQ), "--batch",
         str(LM_BATCH), "--d-model", str(LM["d_model"]), "--n-heads",
         str(LM["n_heads"]), "--n-layers", str(LM["n_layers"]), "--d-ff",
         str(LM["d_ff"])])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train_lm.run(args)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = summary["losses"]
    if summary["steps"] != steps or not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"train_lm: losses did not fall: {losses}")
    log(f"[train_lm] --bf16 d{LM['d_model']} L{LM['n_layers']} "
        f"seq {LM_SEQ} b{LM_BATCH}, {steps} steps in {wall:.2f} s "
        f"({summary['tokens_per_sec']:.1f} tokens/s after the first step): "
        f"losses {losses}; sample {summary['sample']}; launches {counts}")
    return {"losses": losses, "wall_s": wall,
            "tokens_per_s": summary["tokens_per_sec"], "launches": counts}


# -------------------------------------------- phases 13-14: e2e, resume

def phase_digits_e2e(torch):
    """``examples/digits/e2e.py`` on the card: the digits sheet through
    the captured harness (300 steps at b512) and the six-function
    MapReduce loop (up to 60 steps, patience 10); both validation
    accuracies at least 0.95 and within 0.05 of each other."""
    from lua_mapreduce_tpu_torch.examples.digits import e2e
    t0 = time.perf_counter()
    out = e2e.run("cuda")
    wall = time.perf_counter() - t0
    h, m = out["harness_path"], out["mapreduce_path"]
    log(f"[digits e2e] harness {h['val_accuracy']} ({h['steps']} captured "
        f"steps at b{h['batch']}, {h['captures']} capture), MapReduce "
        f"{m['val_accuracy']} ({m['steps']} steps, val loss "
        f"{m['val_loss']}); the JAX package on the CPU: "
        f"{out['jax_package']['harness_path']} / "
        f"{out['jax_package']['mapreduce_path']} (target "
        f"{out['target_accuracy']}); {wall:.1f} s")
    if not out["both_reach_target"] or out["agree_within"] > 0.05:
        raise AssertionError(f"digits e2e: {out}")
    return {**out, "wall_s": wall}


def phase_resume(torch, epochs=(3, 5)):
    """``fit(conf=)`` on the card with a FileJobStore-backed persistent
    table and a shared: checkpoint store: 3 epochs, then a fresh trainer
    — whose step was captured before the load — resumes to 5. Its
    epochs are [4, 5] and its parameters equal those of one run that
    never stopped, bit for bit."""
    import shutil

    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.coord.persistent_table import (
        PersistentTable)
    from lua_mapreduce_tpu_torch.models.mlp import init_mlp, nll_loss
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.train.data import make_digits
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    root = os.path.join(REPO, "build", "smoke-resume")
    shutil.rmtree(root, ignore_errors=True)
    data = make_digits(seed=0)

    def trainer(seed, n):
        return DataParallelTrainer(
            nll_loss, init_mlp(seed, device="cuda"),
            TrainConfig(max_epochs=n, patience=10), device="cuda")

    def fit(tr, tag):
        store = get_storage_from(f"shared:{os.path.join(root, tag, 'ckpt')}")
        conf = PersistentTable("conf", FileJobStore(os.path.join(
            root, tag, "coord")))
        return tr.fit(*data, checkpoint_store=store, conf=conf)

    t0 = time.perf_counter()
    fit(trainer(0, epochs[0]), "stopped")
    resumed = trainer(7, epochs[1])
    resumed.run_steps(data[0][:128], data[1][:128], 2)  # captured first
    out = fit(resumed, "stopped")
    whole = trainer(0, epochs[1])
    ref = fit(whole, "whole")
    wall = time.perf_counter() - t0
    hist = [h["epoch"] for h in out["history"]]
    same = all(torch.equal(resumed.params[k], whole.params[k])
               for k in whole.params)
    log(f"[resume] {epochs[0]} epochs, then a fresh trainer (its step "
        f"captured before the load, {resumed.traces} capture) resumed "
        f"epochs {hist}; parameters "
        f"{'equal' if same else 'DIFFER from'} the never-stopped "
        f"{epochs[1]}-epoch run's; {wall:.1f} s")
    if hist != list(range(epochs[0] + 1, epochs[1] + 1)) or not same \
            or resumed.traces != 1:
        raise AssertionError(f"resume: epochs {hist}, parameters equal "
                             f"{same}, captures {resumed.traces}")
    shutil.rmtree(root, ignore_errors=True)
    return {"resumed_epochs": hist, "params_equal": same,
            "val_loss": [h["val_loss"] for h in out["history"]],
            "never_stopped_val_loss": [h["val_loss"]
                                       for h in ref["history"]][epochs[0]:],
            "wall_s": wall}


# ------------------------- phases 15-18: the data-parallel plane (PR 10)

def card_mesh(torch):
    """The world-size-1 mesh on the card: NCCL, or the run fails."""
    import torch.distributed as dist

    from lua_mapreduce_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cuda")
    if "nccl" not in dist.get_backend():
        raise AssertionError(f"the card's mesh runs {dist.get_backend()}, "
                             f"not NCCL")
    return mesh


@contextlib.contextmanager
def timed_replays(torch, module):
    """Within the block, ``module``'s captured loops record a CUDA event
    before their first replay and after each one: the yielded dict gives
    the device-timeline ms from the first replay's start to the last
    one's end and the number of replays — the steady loop, without the
    eager warm-up step and the capture (whose host time includes
    ``torch.cuda.graph``'s own synchronize and garbage collection)."""
    real = module.CapturedGraph
    rec = {"replays": 0}

    class Timed(real):
        def replay(self):
            if "start" not in rec:
                rec["start"] = torch.cuda.Event(enable_timing=True)
                rec["start"].record()
            out = super().replay()
            rec["end"] = torch.cuda.Event(enable_timing=True)
            rec["end"].record()
            rec["replays"] += 1
            return out

    # a cached graph (graphs.scan's cache) was captured by the real
    # class: start and end the block with an empty cache
    clear = getattr(module, "clear_cache", lambda: None)
    clear()
    module.CapturedGraph = Timed
    try:
        yield rec
    finally:
        module.CapturedGraph = real
        clear()
    rec["end"].synchronize()
    rec["ms"] = rec["start"].elapsed_time(rec["end"])


def timed(torch, ops, fn):
    """``fn()`` on the card: its result, host ms of the call (ending in a
    synchronize), peak GiB above the memory in use before it, and the
    launches counted over it (zeroed just before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 30, \
        counts


def captured_vs_eager(torch, ops, name, run, n, want_counts):
    """A captured loop (``graphs.scan``; ``run(n_iters)`` runs it)
    against the same loop run eagerly on the card: outputs bit for bit,
    the launches of the captured run as the code counts them, both timed
    (host clock; the replays also on the device timeline), and the
    device idle share of a replayed iteration: an iteration's kernel
    time is the profiled kernel time of a 2n-iteration call less that of
    an n-iteration one, over n (what runs once per call — the set-up,
    the work after the loop — cancels)."""
    from lua_mapreduce_tpu_torch import graphs
    run(n)                                 # warm-up: allocator, libraries
    with timed_replays(torch, graphs) as replays:
        res, ms, peak, counts = timed(torch, ops, lambda: run(n))
    replay_ms = replays["ms"] / replays["replays"]
    if counts != want_counts:
        raise AssertionError(f"{name} launches {counts}, expected "
                             f"{want_counts}")
    capture_ms = graphs.captures()[1][1]
    with eager_graphs(graphs):
        eres, e_ms, e_peak, _ = timed(torch, ops, lambda: run(n))
    equal = all(torch.equal(a, b) for a, b in zip(res, eres))
    if not equal:
        raise AssertionError(f"{name}: the captured loop differs from the "
                             f"eager loop")
    kernels = kernel_profile(torch, lambda: run(n))
    dev_ms = sum(k[1] for k in kernels)
    dev2_ms = sum(k[1] for k in kernel_profile(torch, lambda: run(2 * n)))
    iter_ms = (dev2_ms - dev_ms) / n
    return res, {"ms": ms, "ms_per_iter": ms / n, "capture_ms": capture_ms,
                 "replay_ms_per_iter": replay_ms,
                 "eager_ms": e_ms, "eager_ms_per_iter": e_ms / n,
                 "peak_mem_gib": peak, "eager_peak_mem_gib": e_peak,
                 "equal_to_eager": equal, "launches": counts,
                 "profiled_device_ms": dev_ms,
                 "kernel_ms_per_iter": iter_ms,
                 "device_idle_share": 1 - iter_ms / replay_ms,
                 "top_kernels": kernels[:8]}


def hold_to_cpu(name, torch, got, want, rtol=1e-4, atol=1e-4):
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        if not torch.allclose(g.cpu(), w, rtol=rtol, atol=atol):
            raise AssertionError(f"{name}: the card's result differs from "
                                 f"the CPU's (max abs err {err:.3e})")
    return err


def phase_kmeans(torch, ops, seed=0):
    """``kmeans_fit`` over the card's mesh: at a size the CPU runs
    (65,536 × 128, k = 64, 10 iterations) the card's centroids equal the
    port's CPU run within 1e-4 (inertia rtol 1e-3); at SIFT1M's shape,
    20 Lloyd iterations captured (one eager warm-up iteration and 19
    replays) against the same loop run eagerly, bit for bit, and the
    first two of them against a float64 reference on the CPU
    (:func:`kmeans_reference_check`)."""
    from lua_mapreduce_tpu_torch.models import kmeans
    from lua_mapreduce_tpu_torch.train.data import make_blobs
    mesh = card_mesh(torch)
    # from x[:64], as the JAX suite's mesh test starts from x[:8]: from
    # randomly drawn centroids this data's 10-iteration fit turns on the
    # summation order (assignments near a tie flip, and the flips
    # compound): a CPU run on the rows permuted parts from the unpermuted
    # one by more than 1e-2; from x[:64] by less than 1e-6 (tests/test_
    # torch_kmeans_als.py::test_kmeans_card_check_start_avoids_
    # assignment_ties). The full-size fit is held below to a reference
    # that accounts for each flip.
    xs, _, _ = make_blobs(seed=1, n=65536, k=64, dim=KMEANS_DIM)
    c0s = xs[:64]
    card = kmeans.kmeans_fit(xs, c0s, n_iters=10, mesh=mesh)
    cpu = kmeans.kmeans_fit(xs, c0s, n_iters=10, device="cpu")
    err = hold_to_cpu("kmeans 65536x128 k64", torch, card[:1], cpu[:1])
    hold_to_cpu("kmeans 65536x128 k64 history", torch, card[2:], cpu[2:],
                rtol=1e-3, atol=0.0)
    res, r, x, xd, c0 = kmeans_timed(torch, ops, mesh, seed)
    setup_s = r["setup_s"]
    hist = res.history.cpu().tolist()
    if not all(math.isfinite(h) for h in hist) or any(
            b > a * (1 + 1e-6) for a, b in zip(hist, hist[1:])):
        raise AssertionError(f"kmeans inertia not finite and falling: {hist}")
    t0 = time.perf_counter()
    full = kmeans_reference_check(torch, kmeans, x, xd, c0, mesh, hist)
    full["seconds"] = time.perf_counter() - t0
    r.update(history=hist, cpu_check_max_abs_err=err, setup_s=setup_s,
             full_size_check=full)
    log(f"[kmeans] {KMEANS_N}x{KMEANS_DIM} f32, k={KMEANS_K}, "
        f"{KMEANS_ITERS} iterations on a dp=1 NCCL mesh: a replayed "
        f"iteration {r['replay_ms_per_iter']:.3f} ms on the device "
        f"({r['kernel_ms_per_iter']:.3f} ms of kernels: idle "
        f"{100 * r['device_idle_share']:.1f}%); the captured call "
        f"{r['ms_per_iter']:.3f} ms/iteration ({r['ms']:.1f} ms, capture "
        f"{r['capture_ms']:.1f} ms of host time), the eager loop "
        f"{r['eager_ms_per_iter']:.3f}; equal bit for bit; peak "
        f"{r['peak_mem_gib']:.2f} GiB above the data (eager "
        f"{r['eager_peak_mem_gib']:.2f}); launches {r['launches']}")
    log(f"[kmeans] inertia history {hist}")
    log(f"[kmeans] 65536x128 k=64: card equals the CPU run within 1e-4 "
        f"(max abs err {err:.3e}); data set-up {setup_s:.1f} s")
    log(f"[kmeans] full size against float64 on the CPU: "
        f"{full['label_mismatches']} of {KMEANS_N} assignments differ, the "
        f"largest gap {full['max_mismatch_gap']:.3e} within its f32 bound "
        f"(largest bound share {full['max_gap_share']:.3f}); centroids "
        f"after the first update within {full['centroid_max_abs_err']:.3e}; "
        f"history[0..1] relative errors {full['history_rel_err']}; "
        f"{full['seconds']:.1f} s")
    for kname, ms, cnt in r["top_kernels"]:
        log(f"[kmeans]   {ms:10.3f} ms {cnt:6d}x  {kname[:90]}")
    del x, xd
    torch.cuda.empty_cache()
    return r["launches"], r


def kmeans_timed(torch, ops, mesh, seed=0):
    """Phase 15's timed part (``chip_ab.py`` runs it too): blobs of
    SIFT1M's shape from ``seed`` and KMEANS_ITERS Lloyd iterations
    captured against the same loop run eagerly (:func:`captured_vs_eager`).
    Returns the captured fit, its report (with the data's ``setup_s``),
    the data on the host and on the card, and the start centroids."""
    from lua_mapreduce_tpu_torch.models import kmeans
    from lua_mapreduce_tpu_torch.train.data import make_blobs
    t0 = time.perf_counter()
    x, _, _ = make_blobs(seed=seed, n=KMEANS_N, k=KMEANS_K, dim=KMEANS_DIM)
    c0 = kmeans.init_centroids(seed, x, KMEANS_K, method="random")
    xd = torch.from_numpy(x).cuda()
    setup_s = time.perf_counter() - t0
    want = {**dict.fromkeys(ops.KERNELS, 0), "matmul_f32": 2 * KMEANS_ITERS}
    res, r = captured_vs_eager(
        torch, ops, "kmeans",
        lambda n: kmeans.kmeans_fit(xd, c0, n_iters=n, mesh=mesh),
        KMEANS_ITERS, want)
    r["setup_s"] = setup_s
    return res, r, x, xd, c0


def _nearest_f64(torch, x64, c64, rows=65536):
    """Each row's nearest centroid and its squared distance, in float64
    on the CPU, a block of rows at a time."""
    labels, dmin = [], []
    cc = (c64 * c64).sum(1)
    for s in range(0, len(x64), rows):
        xb = x64[s:s + rows]
        d = (xb * xb).sum(1, keepdim=True) + cc[None, :] - 2.0 * xb @ c64.t()
        m, i = d.min(1)
        labels.append(i)
        dmin.append(m)
    return torch.cat(labels), torch.cat(dmin)


def kmeans_reference_check(torch, kmeans, x, xd, c0, mesh, hist):
    """The full-size fit's first two iterations against a float64
    reference written with plain torch ops on the CPU.

    Assignments: the card's labels (``kmeans.assign``, the fit's own
    formula and kernel) may differ from the reference's only where the
    two candidates' true distances lie within the worst-case f32
    rounding of the card's computed ones — 2·γ_K·(‖c‖² + 2‖x‖‖c‖) per
    candidate, γ_K = K·u/(1 − K·u), u = 2⁻²⁴, K the width — so a flip
    at a near tie passes and any other fails. The centroids after the
    first update (``kmeans_fit`` with one iteration) equal the float64
    mean over the card's labels within 1e-4 (empty clusters keep their
    centroid); history[0] and history[1] equal the reference inertia
    against the start and against those centroids, rtol 1e-3."""
    x64 = torch.from_numpy(x).double()
    c64 = c0.double()
    k, dim = c64.shape
    ref_labels, d0 = _nearest_f64(torch, x64, c64)
    card_labels = kmeans.assign(xd, c0.cuda()).cpu()
    mis = torch.nonzero(card_labels != ref_labels).flatten()
    xm = x64[mis]
    gap = (((xm - c64[card_labels[mis]]) ** 2).sum(1)
           - ((xm - c64[ref_labels[mis]]) ** 2).sum(1))
    u = 2.0 ** -24
    gamma = dim * u / (1 - dim * u)
    cn = c64.norm(dim=1)
    xn = xm.norm(dim=1)
    bound = sum(2 * gamma * (cn[lab] ** 2 + 2 * xn * cn[lab])
                for lab in (card_labels[mis], ref_labels[mis]))
    share = (gap / bound).max().item() if len(mis) else 0.0
    if len(mis) and share > 1.0:
        raise AssertionError(f"kmeans: {int((gap > bound).sum())} of "
                             f"{len(mis)} differing assignments are not "
                             f"near ties (largest gap {gap.max():.3e})")
    c1 = kmeans.kmeans_fit(xd, c0, n_iters=1, mesh=mesh).centroids.cpu()
    sums = torch.zeros_like(c64).index_add_(0, card_labels, x64)
    counts = torch.bincount(card_labels, minlength=k).double()
    want = torch.where(counts[:, None] > 0,
                       sums / counts.clamp_min(1)[:, None], c64)
    c_err = hold_to_cpu("kmeans full-size first update", torch, [c1],
                        [want.float()])
    _, d1 = _nearest_f64(torch, x64, c1.double())
    ref_hist = [d0.sum().item(), d1.sum().item()]
    rel = [abs(h - w) / w for h, w in zip(hist[:2], ref_hist)]
    if max(rel) > 1e-3:
        raise AssertionError(f"kmeans history {hist[:2]} against the "
                             f"float64 reference {ref_hist}: relative "
                             f"errors {rel}")
    return {"label_mismatches": len(mis),
            "max_mismatch_gap": gap.max().item() if len(mis) else 0.0,
            "max_gap_share": share, "centroid_max_abs_err": c_err,
            "history_ref": ref_hist, "history_rel_err": rel}


def phase_als(torch, ops, seed=0):
    """``als_fit`` over the card's mesh: at 600 × 300, rank 16, 20%
    observed, the card equals the CPU run within 1e-4; at MovieLens-1M's
    shape, 10 rounds captured against the same loop run eagerly, bit for
    bit."""
    from lua_mapreduce_tpu_torch.models import als
    from lua_mapreduce_tpu_torch.train.data import make_ratings
    mesh = card_mesh(torch)
    # 20% observed: at ML-1M's 4.47% a user of this small check would
    # have ~13 ratings for 16 unknowns, systems held up by reg alone
    rs, ws = make_ratings(seed=2, n_users=600, n_items=300, rank=16,
                          density=0.2, noise=0.1)
    v0s = als.init_item_factors(2, 300, 16)
    card = als.als_fit(rs, ws, v0s, n_iters=4, reg=ALS_REG, mesh=mesh)
    cpu = als.als_fit(rs, ws, v0s, n_iters=4, reg=ALS_REG, device="cpu")
    err = hold_to_cpu("als 600x300 rank 16", torch, card, cpu)
    res, rep = als_timed(torch, ops, mesh, seed)
    observed = rep["observed_share"]
    hist = res.history.cpu().tolist()
    if not all(math.isfinite(h) for h in hist) or hist[-1] >= hist[0]:
        raise AssertionError(f"als RMSE not finite and falling: {hist}")
    rep.update(history=hist, cpu_check_max_abs_err=err)
    log(f"[als] {ALS_USERS}x{ALS_ITEMS}, {100 * observed:.2f}% observed, "
        f"rank {ALS_RANK}, reg {ALS_REG}, {ALS_ITERS} rounds on a dp=1 NCCL "
        f"mesh: a replayed round {rep['replay_ms_per_iter']:.3f} ms on the "
        f"device ({rep['kernel_ms_per_iter']:.3f} ms of kernels: idle "
        f"{100 * rep['device_idle_share']:.1f}%); the captured call "
        f"{rep['ms_per_iter']:.3f} ms/round ({rep['ms']:.1f} ms, capture "
        f"{rep['capture_ms']:.1f} ms of host time), the eager loop "
        f"{rep['eager_ms_per_iter']:.3f}; equal bit for bit; peak "
        f"{rep['peak_mem_gib']:.2f} GiB (eager "
        f"{rep['eager_peak_mem_gib']:.2f}); launches {rep['launches']}")
    log(f"[als] RMSE history {hist}; 600x300 rank 16: card equals the CPU "
        f"run within 1e-4 (max abs err {err:.3e})")
    for kname, ms, cnt in rep["top_kernels"]:
        log(f"[als]   {ms:10.3f} ms {cnt:6d}x  {kname[:90]}")
    return rep["launches"], rep


def als_timed(torch, ops, mesh, seed=0):
    """Phase 16's timed part (``chip_ab.py`` runs it too): ratings of
    MovieLens-1M's shape from ``seed`` and ALS_ITERS rounds captured
    against the same loop run eagerly. Returns the captured fit and its
    report (with the ratings' ``observed_share``)."""
    from lua_mapreduce_tpu_torch.models import als
    from lua_mapreduce_tpu_torch.train.data import make_ratings
    r, w = make_ratings(seed=seed, n_users=ALS_USERS, n_items=ALS_ITEMS,
                        rank=ALS_RANK, density=ALS_DENSITY, noise=0.1)
    v0 = als.init_item_factors(seed, ALS_ITEMS, ALS_RANK)
    rd, wd = torch.from_numpy(r).cuda(), torch.from_numpy(w).cuda()
    # per round: the users' two products, the items' two, the RMSE's one;
    # then the final users' two
    want = {**dict.fromkeys(ops.KERNELS, 0),
            "matmul_f32": 5 * ALS_ITERS + 2}
    res, rep = captured_vs_eager(
        torch, ops, "als",
        lambda n: als.als_fit(rd, wd, v0, n_iters=n, reg=ALS_REG,
                              mesh=mesh), ALS_ITERS, want)
    rep["observed_share"] = float(w.mean())
    return res, rep


def phase_dp_train(torch, ops, gen):
    """The trainer over the card's mesh (dp = 1, NCCL) on the digits MLP
    (b128 f32) and LeNet-5 b1024 bf16, replicated and with ZeRO-1: its
    captured steps, with the collectives inside the graph, give the
    no-mesh trainer's losses and parameters bit for bit; ms/step of
    each beside the no-mesh step's. Counts are zeroed before each timed
    run and read after it."""
    from lua_mapreduce_tpu_torch.models.mlp import init_mlp, nll_loss
    from lua_mapreduce_tpu_torch.train.data import make_digits
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    mesh = card_mesh(torch)
    xd, yd, _, _ = make_digits(seed=0)
    models = {"digits": (nll_loss, init_mlp(0, device="cuda"),
                         torch.from_numpy(xd[:128]).cuda(),
                         torch.from_numpy(yd[:128]).long().cuda(),
                         {"matmul_f32": 5, "rowwise_softmax": 1})}
    loss_fn, params, shape, n_cls, _, per_step = conv_model(
        "lenet5_cifar", torch.bfloat16, "cuda")
    x = torch.randn((1024, *shape), device="cuda", generator=gen).to(
        torch.bfloat16)
    y = torch.randint(0, n_cls, (1024,), device="cuda", generator=gen)
    models["lenet5_cifar"] = (loss_fn, params, x, y, per_step)
    out, runs = {}, []
    for name, (loss_fn, params, x, y, per_step) in models.items():
        rows, steps = {}, DP_STEPS[name]
        for tag in ("no mesh", "mesh", "mesh zero1"):
            cfg = TrainConfig(batch_size=len(x), zero1=tag == "mesh zero1")
            kw = {"device": "cuda"} if tag == "no mesh" else {"mesh": mesh}
            tr = DataParallelTrainer(loss_fn, params, cfg, **kw)
            first = tr.step(x, y)           # the eager warm-up, the capture
            warm = tr.run_steps(x, y, 3)
            losses, ms, _, counts = timed(
                torch, ops, lambda: tr.run_steps(x, y, steps))
            want = {**dict.fromkeys(ops.KERNELS, 0),
                    **{k: steps * v for k, v in per_step.items()}}
            if counts != want:
                raise AssertionError(f"dp {name} {tag} launches {counts}, "
                                     f"expected {want}")
            rows[tag] = {"step_ms": ms / steps, "launches": counts,
                         "losses": [first] + [float(v) for v in torch.cat(
                             [warm, losses])],
                         "params": {k: v.detach().clone()
                                    for k, v in tr.params.items()},
                         "buffers": tr.momentum_buffers(),
                         "captures": tr.traces}
            runs.append(counts)
            del tr
        ref = rows["no mesh"]
        for tag in ("mesh", "mesh zero1"):
            got = rows[tag]
            same = (got["losses"] == ref["losses"] and all(
                torch.equal(got[key][k], ref[key][k])
                for key in ("params", "buffers") for k in ref["params"]))
            if not same:
                raise AssertionError(f"dp {name} {tag}: losses, parameters "
                                     f"or momentum differ from the no-mesh "
                                     f"trainer's")
            got["equal_to_no_mesh"] = same
        for r in rows.values():
            del r["params"], r["buffers"]
        log(f"[dp] {name} b{len(x)}: captured ms/step no mesh "
            f"{rows['no mesh']['step_ms']:.4f}, mesh "
            f"{rows['mesh']['step_ms']:.4f}, mesh + ZeRO-1 "
            f"{rows['mesh zero1']['step_ms']:.4f}; losses, parameters and "
            f"momentum of both mesh runs equal the no-mesh run's bit for bit "
            f"(an NCCL sum over one rank copies); launches per run "
            f"{rows['mesh']['launches']}")
        out[name] = rows
    return runs, out


def phase_executor(torch, ops):
    """TpuExecutor over the card's mesh against the CPU: ``run_keyed`` of
    the digits gradient (1e-4), ``run_bucketed`` of a 16-partition
    histogram of 2²⁰ ids (exact) and ``run_loop`` of a step with an
    all-reduce inside (1e-6)."""
    from lua_mapreduce_tpu_torch.models.mlp import init_mlp, nll_loss
    from lua_mapreduce_tpu_torch.parallel import ArrayTaskSpec, TpuExecutor
    from lua_mapreduce_tpu_torch.parallel import collectives as C
    from lua_mapreduce_tpu_torch.train.data import make_digits
    mesh = card_mesh(torch)
    xd, yd, _, _ = make_digits(seed=1)
    params = init_mlp(3, device="cpu")

    def grad_map(device):
        p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}

        def mapfn(shard):
            g = torch.autograd.grad(nll_loss(p, *shard), list(p.values()))
            return dict(zip(p, g))
        return mapfn

    batch = (xd[:512], yd[:512].astype("int64"))
    ops.reset_launch_counts()
    got = TpuExecutor(ArrayTaskSpec(mapfn=grad_map("cuda"),
                                    reduce_op="mean"), mesh).run_keyed(batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {**dict.fromkeys(ops.KERNELS, 0), "matmul_f32": 5,
            "rowwise_softmax": 1}
    if counts != want:
        raise AssertionError(f"executor launches {counts}, expected {want}")
    ref = grad_map("cpu")((torch.from_numpy(batch[0]),
                           torch.from_numpy(batch[1])))
    k_err = hold_to_cpu("run_keyed digits gradient", torch,
                        [got[k] for k in params], [ref[k] for k in params])
    ids = torch.randint(0, 1024, (1 << 20,),
                        generator=torch.Generator().manual_seed(4))
    spec = ArrayTaskSpec(
        mapfn=lambda s: torch.zeros(1024, dtype=torch.int32,
                                    device=s.device).index_add_(
            0, s, torch.ones_like(s, dtype=torch.int32)),
        partitionfn=lambda c: c.reshape(16, 64), num_partitions=16)
    hist = TpuExecutor(spec, mesh).run_bucketed(ids)
    if not torch.equal(hist.cpu().reshape(-1),
                       torch.bincount(ids, minlength=1024).int()):
        raise AssertionError("run_bucketed histogram differs from the CPU's")
    # the loop's reference on the CPU: a sum over one rank is the value
    s0 = torch.linspace(-1, 1, 4096)

    def step(s):
        t = C.psum(s * 0.9, mesh, "dp")
        return torch.tanh(t) + 0.1, t.sum()

    card = TpuExecutor(spec, mesh).run_loop(s0, step, n_steps=50)
    state, trace = s0, []
    for _ in range(50):
        trace.append((state * 0.9).sum())
        state = torch.tanh(state * 0.9) + 0.1
    l_err = hold_to_cpu("run_loop", torch, card,
                        [state, torch.stack(trace)], rtol=1e-6, atol=1e-5)
    log(f"[executor] run_keyed digits gradient (b512, dp=1 NCCL mesh) "
        f"within {k_err:.3e} of the CPU, launches {counts}; run_bucketed "
        f"16-partition histogram of 2^20 ids equals the CPU's; run_loop "
        f"(50 steps with an all-reduce, captured) within {l_err:.3e}")
    return counts, {"keyed_max_abs_err": k_err, "loop_max_abs_err": l_err}


# --------------------- phases 19-20: the compiled MapReduce tiers (PR 11)

def run_task(torch, ops, module, engine, args, tag, finalfn=None):
    """A six-function example under the port's LocalExecutor with the
    given engine: the executor, and the run's host ms, peak GiB above
    the memory in use before it and launches (``timed``)."""
    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    spec = TaskSpec(taskfn=module, mapfn=module, partitionfn=module,
                    reducefn=module, finalfn=finalfn or module,
                    init_args=args, storage=f"mem:smoke-{tag}")
    ex = LocalExecutor(spec, engine=engine, max_iterations=100)
    _, ms, peak, counts = timed(torch, ops, ex.run)
    return ex, ms, peak, counts


def iteration_ms(ex):
    """(the first iteration's ms — the in-graph build, with its capture
    — and the mean ms of the later ones), host clock."""
    walls = [1e3 * it.wall_time for it in ex.stats.iterations]
    return walls[0], sum(walls[1:]) / max(1, len(walls) - 1)


def hold_compiled(name, ex, n_iter, counts, want):
    """The in-graph run's own checks: one build, every iteration
    compiled, no fallback, the launches the code counts."""
    engine = ex._ingraph.engine
    its = ex.stats.iterations
    if engine is None or engine.traces != 1 \
            or sum(it.ingraph_iterations for it in its) != n_iter \
            or sum(it.ingraph_fallbacks for it in its) != 0:
        raise AssertionError(
            f"{name}: in-graph builds {getattr(engine, 'traces', None)}, "
            f"compiled iterations "
            f"{sum(it.ingraph_iterations for it in its)} of {n_iter}, "
            f"fallbacks {sum(it.ingraph_fallbacks for it in its)}")
    if counts != want:
        raise AssertionError(f"{name} launches {counts}, expected {want}")


def _near_tie_share(torch, xm, c64, lab_a, lab_b):
    """Rows ``xm`` (float64) that two f32 computations assigned to
    centroids ``lab_a`` and ``lab_b``: the largest share, over them, of
    the float64 gap between the two candidates' squared distances over
    the f32 rounding bound of computing them (≤ 1: a near tie). The
    bound, 2·γ_K·(‖x‖ + ‖c‖)² per candidate (γ_K = K·u/(1 − K·u),
    u = 2⁻²⁴), covers both formulas (with and without ‖x‖²)."""
    if not len(xm):
        return 0.0
    dim = c64.shape[1]
    u = 2.0 ** -24
    gamma = dim * u / (1 - dim * u)
    gap = (((xm - c64[lab_a]) ** 2).sum(1)
           - ((xm - c64[lab_b]) ** 2).sum(1)).abs()
    xn = xm.norm(dim=1)
    bound = sum(2 * gamma * (xn + c64.norm(dim=1)[lab]) ** 2
                for lab in (lab_a, lab_b))
    return (gap / bound).max().item()


def _f64_means(torch, xd, labels, c_prev):
    """Float64 cluster means of the points ``xd`` (on the card) over
    ``labels``; empty clusters keep ``c_prev``."""
    k = c_prev.shape[0]
    sums = torch.zeros((k, xd.shape[1]), dtype=torch.float64,
                       device=xd.device).index_add_(0, labels, xd.double())
    counts = torch.bincount(labels, minlength=k).double()[:, None]
    return torch.where(counts > 0, sums / counts.clamp_min(1),
                       c_prev.double().to(xd.device)).cpu()


def phase_ingraph(torch, ops):
    """The six-function examples on the in-graph engine, forced
    (``engine="ingraph"``: a lowering failure raises), against the store
    plane on the card, the CPU and the native fits; launches counted
    over each run and equal to the code's (a replay credits its
    capture's)."""
    import numpy as np

    from lua_mapreduce_tpu_torch.examples.als import mr_als
    from lua_mapreduce_tpu_torch.examples.digits import mr_sgd
    from lua_mapreduce_tpu_torch.examples.kmeans import mr_kmeans
    from lua_mapreduce_tpu_torch.models import als, kmeans
    from lua_mapreduce_tpu_torch.train.data import make_ratings
    zero = dict.fromkeys(ops.KERNELS, 0)
    card_counts, rep = [], {}

    # mr_sgd: 5 products and a log-softmax a map job, 4 jobs an iteration
    n = SGD_ARGS["max_steps"]
    want = {**zero, "matmul_f32": 20 * n, "rowwise_softmax": 4 * n}
    sgd = {}
    for engine, device in (("ingraph", "cuda"), ("store", "cuda"),
                           ("ingraph", "cpu")):
        ex, ms, peak, counts = run_task(
            torch, ops, "lua_mapreduce_tpu_torch.examples.digits.mr_sgd",
            engine, {**SGD_ARGS, "device": device},
            f"sgd-{engine}-{device}")
        st = mr_sgd.read_state()
        sgd[engine, device] = (ex, ms, peak, counts,
                               {k: v.copy() for k, v in st["params"].items()},
                               st["val_loss"])
    ex, ms, peak, counts, params, val = sgd["ingraph", "cuda"]
    hold_compiled("mr_sgd", ex, n, counts, want)
    if ex._ingraph.engine.mode != "shard_map":
        raise AssertionError(f"mr_sgd ran on the {ex._ingraph.engine.mode} "
                             f"tier, not the collective one")
    s_ex, s_ms, _, s_counts, s_params, s_val = sgd["store", "cuda"]
    if s_counts != want:
        raise AssertionError(f"mr_sgd store launches {s_counts}, expected "
                             f"{want}")
    errs = {}
    for other in (("store", "cuda"), ("ingraph", "cpu")):
        o_params, o_val = sgd[other][4], sgd[other][5]
        for k in params:
            np.testing.assert_allclose(params[k], o_params[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"mr_sgd {k} "
                                       f"against {other}")
        np.testing.assert_allclose(val, o_val, rtol=1e-4)
        errs["/".join(other)] = max(float(np.abs(params[k] - o_params[k])
                                          .max()) for k in params)
    card_counts += [counts, s_counts]
    first, steady = iteration_ms(ex)
    s_first, s_steady = iteration_ms(s_ex)
    rep["mr_sgd"] = {"iterations": n, "mode": ex._ingraph.engine.mode,
                     "traces": ex._ingraph.engine.traces,
                     "folds": sorted(set(
                         ex._ingraph.engine._plan.folds.values())),
                     "ms": ms, "first_iteration_ms": first,
                     "ms_per_iteration": steady, "store_ms": s_ms,
                     "store_ms_per_iteration": s_steady,
                     "peak_mem_gib": peak, "val_loss": val,
                     "max_abs_err": errs, "launches": counts}
    log(f"[ingraph] mr_sgd 256-128-10, 4x128, {n} iterations: mode "
        f"{ex._ingraph.engine.mode} ({'/'.join(rep['mr_sgd']['folds'])}), "
        f"1 build; {steady:.2f} ms/iteration after the first ({first:.1f} "
        f"ms: build + capture), the store plane on the card "
        f"{s_steady:.2f} ms/iteration ({s_steady / steady:.1f}x); "
        f"parameters within {errs} of the store plane / the CPU in-graph "
        f"run; val loss {val:.6f}; launches {counts}")

    # mr_kmeans at SIFT1M's shape: 2 products a map job, 8 jobs
    args = {"k": KMEANS_K, "n": KMEANS_N, "dim": KMEANS_DIM,
            "n_shards": MRKM_SHARDS, "max_iters": MRKM_ITERS, "tol": 0.0,
            "seed": 0, "coord": "mem", "device": "cuda"}
    want = {**zero, "matmul_f32": 2 * MRKM_SHARDS * MRKM_ITERS}
    first_update, km = {}, {}

    def recording(engine):
        def finalfn(pairs):
            verdict = mr_kmeans.finalfn(pairs)
            first_update.setdefault(engine, np.asarray(
                mr_kmeans.read_state("mem")["centroids"], np.float32))
            return verdict
        return {"finalfn": finalfn}

    for engine in ("ingraph", "store"):
        ex, ms, peak, counts = run_task(
            torch, ops, "lua_mapreduce_tpu_torch.examples.kmeans.mr_kmeans",
            engine, args, f"km-{engine}", finalfn=recording(engine))
        if counts != want:
            raise AssertionError(f"mr_kmeans {engine} launches {counts}, "
                                 f"expected {want}")
        km[engine] = (ex, ms, peak, counts, mr_kmeans.read_state("mem"))
    ex, ms, peak, counts, st = km["ingraph"]
    hold_compiled("mr_kmeans", ex, MRKM_ITERS, counts, want)
    s_ex, s_ms, _, s_counts, s_st = km["store"]
    np.testing.assert_allclose(st["centroids"], s_st["centroids"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(st["sse"], s_st["sse"], rtol=1e-4)
    card_counts += [counts, s_counts]
    # against kmeans_fit from the same start (the table's x[:k]): the
    # two formulas' assignments may differ only at near ties, and each
    # side's first update equals the float64 mean over its own labels
    xd = mr_kmeans._x
    c0 = xd[:KMEANS_K].clone()
    fit_labels = kmeans.assign(xd, c0)
    mr_labels = torch.empty_like(fit_labels)
    for s_ in range(MRKM_SHARDS):
        mr_labels[s_::MRKM_SHARDS] = mr_kmeans._assign(
            xd[s_::MRKM_SHARDS], c0)[1]
    mis = torch.nonzero(fit_labels != mr_labels).flatten()
    c64 = c0.double().cpu()
    share = _near_tie_share(torch, xd[mis].double().cpu(), c64,
                            fit_labels[mis].cpu(), mr_labels[mis].cpu())
    if share > 1.0:
        raise AssertionError(f"mr_kmeans: assignments differ from "
                             f"kmeans_fit's away from a tie (share "
                             f"{share:.3f})")
    c1_fit = kmeans.kmeans_fit(xd, c0, n_iters=1,
                               device="cuda").centroids.cpu()
    c_err = max(
        hold_to_cpu("mr_kmeans first update", torch,
                    [torch.from_numpy(first_update["ingraph"])],
                    [_f64_means(torch, xd, mr_labels, c0).float()]),
        hold_to_cpu("kmeans_fit first update", torch, [c1_fit],
                    [_f64_means(torch, xd, fit_labels, c0).float()]))
    first, steady = iteration_ms(ex)
    s_first, s_steady = iteration_ms(s_ex)
    rep["mr_kmeans"] = {"iterations": MRKM_ITERS,
                        "mode": ex._ingraph.engine.mode,
                        "traces": ex._ingraph.engine.traces, "ms": ms,
                        "first_iteration_ms": first,
                        "ms_per_iteration": steady, "store_ms": s_ms,
                        "store_first_iteration_ms": s_first,
                        "store_ms_per_iteration": s_steady,
                        "peak_mem_gib": peak, "sse": st["sse"],
                        "assignments_differing_from_fit": len(mis),
                        "max_tie_share": share,
                        "first_update_max_abs_err": c_err,
                        "launches": counts}
    log(f"[ingraph] mr_kmeans {KMEANS_N}x{KMEANS_DIM}, k={KMEANS_K}, "
        f"{MRKM_SHARDS} shards, {MRKM_ITERS} iterations: mode "
        f"{ex._ingraph.engine.mode}, 1 build; {steady:.1f} ms/iteration "
        f"after the first ({first:.1f} ms), the store plane on the card "
        f"{s_steady:.1f} ms/iteration (first {s_first:.1f}); peak "
        f"{peak:.2f} GiB; centroids and SSE equal the store plane's "
        f"within rtol 1e-4; against kmeans_fit: {len(mis)} assignments "
        f"differ, all at near ties (largest share {share:.3f}), first "
        f"updates within {c_err:.3e} of their float64 means; launches "
        f"{counts}")

    # mr_als at MovieLens-100K's shape: 5 products a map job, 4 jobs
    want = {**zero, "matmul_f32": 5 * MRALS_ARGS["n_shards"]
            * MRALS_ARGS["max_iters"]}
    ex, ms, peak, counts = run_task(
        torch, ops, "lua_mapreduce_tpu_torch.examples.als.mr_als",
        "ingraph", {**MRALS_ARGS, "device": "cuda"}, "als-ingraph")
    hold_compiled("mr_als", ex, MRALS_ARGS["max_iters"], counts, want)
    card_counts.append(counts)
    st = mr_als.read_state("mem")
    a = MRALS_ARGS
    r, w = make_ratings(seed=a["seed"], n_users=a["n_users"],
                        n_items=a["n_items"], rank=a["rank"],
                        density=a["density"])
    v0 = 0.1 * np.random.RandomState(a["seed"]).randn(a["n_items"],
                                                       a["rank"])
    fit = als.als_fit(r, w, v0, n_iters=a["max_iters"], reg=a["reg"],
                      device="cuda")
    got = torch.tensor(st["item_factors"])
    wantv = fit.item_factors.cpu()
    a_norm, a_abs = norm_err(got, wantv), float((got - wantv).abs().max())
    if a_norm > MRALS_NORM_TOL or a_abs > MRALS_ABS_TOL:
        raise AssertionError(f"mr_als item factors against als_fit: "
                             f"normwise {a_norm:.3e}, max abs {a_abs:.3e}")
    first, steady = iteration_ms(ex)
    rep["mr_als"] = {"rounds": a["max_iters"],
                     "mode": ex._ingraph.engine.mode,
                     "traces": ex._ingraph.engine.traces, "ms": ms,
                     "first_round_ms": first, "ms_per_round": steady,
                     "peak_mem_gib": peak, "observed_share": float(w.mean()),
                     "rmse": st["rmse"], "fit_history":
                         fit.history.cpu().tolist(),
                     "item_factors_norm_err": a_norm,
                     "item_factors_max_abs_err": a_abs,
                     "launches": counts}
    log(f"[ingraph] mr_als {a['n_users']}x{a['n_items']}, "
        f"{100 * float(w.mean()):.2f}% observed, rank {a['rank']}, "
        f"{a['max_iters']} rounds: mode {ex._ingraph.engine.mode}, 1 build; "
        f"{steady:.1f} ms/round after the first ({first:.1f} ms); item "
        f"factors against als_fit normwise {a_norm:.3e} (<= "
        f"{MRALS_NORM_TOL}), max abs {a_abs:.3e} (<= {MRALS_ABS_TOL}); "
        f"launches {counts}")
    return card_counts, rep, sgd["ingraph", "cuda"][4]


def phase_hybrid_cache(torch, ops):
    """A forced-hybrid (``engine="hybrid"``) int-sum task of wordcount's
    shape on the card, byte-identical to the store plane with both legs
    compiled and no fallback; then ``kmeans_fit`` at phase 15's shape
    called twice — one capture across both (``graphs.scan``'s cache) —
    against the eager loop."""
    import re

    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.models import kmeans
    from lua_mapreduce_tpu_torch.train.data import make_blobs
    root = os.path.join(REPO, "build", "smoke-tasks")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "smoke_wordids.py"), "w") as f:
        f.write(WORDIDS_TASK)
    sys.path.insert(0, root)
    pat = re.compile(r"^result\.P(\d+)$")
    out = {}
    try:
        for engine in ("store", "hybrid"):
            ex, ms, _, counts = run_task(
                torch, ops, "smoke_wordids", engine, {"device": "cuda"},
                f"wordids-{engine}")
            out[engine] = (ex, ms, {n: "".join(ex.result_store.lines(n))
                                    for n in ex.result_store.list(
                                        "result.P*") if pat.match(n)})
    finally:
        sys.path.remove(root)
    h_ex, h_ms, got = out["hybrid"]
    _, s_ms, want_bytes = out["store"]
    it = h_ex.stats.iterations[-1]
    if not got or got != want_bytes or it.hybrid_map_legs < 1 \
            or it.hybrid_reduce_legs < 1 or it.hybrid_fallbacks:
        raise AssertionError(
            f"forced hybrid: bytes equal {got == want_bytes}, map legs "
            f"{it.hybrid_map_legs}, reduce legs {it.hybrid_reduce_legs}, "
            f"fallbacks {it.hybrid_fallbacks}")
    hy = {"map_legs": it.hybrid_map_legs,
          "reduce_legs": it.hybrid_reduce_legs,
          "folded_groups": h_ex._hybrid.fold.folded_groups,
          "map_mode": h_ex._hybrid.map_engine.mode, "ms": h_ms,
          "store_ms": s_ms, "result_files": len(got)}
    log(f"[hybrid] int-sum task (8 jobs x 2048 token ids, 48 words, 4 "
        f"partitions), engine=hybrid: bytes equal the store plane's; map "
        f"leg {hy['map_mode']} ({it.hybrid_map_legs}), {it.hybrid_reduce_legs}"
        f" reduce jobs folded ({hy['folded_groups']} groups), 0 fallbacks; "
        f"{h_ms:.1f} ms against the store plane's {s_ms:.1f}")

    mesh = card_mesh(torch)
    x, _, _ = make_blobs(seed=0, n=KMEANS_N, k=KMEANS_K, dim=KMEANS_DIM)
    c0 = kmeans.init_centroids(0, x, KMEANS_K, method="random")
    xd = torch.from_numpy(x).cuda()
    del x

    def fit():
        return kmeans.kmeans_fit(xd, c0, n_iters=KMEANS_ITERS, mesh=mesh)

    want = {**dict.fromkeys(ops.KERNELS, 0), "matmul_f32": 2 * KMEANS_ITERS}
    graphs.clear_cache()
    graphs.reset_captures()
    r1, ms1, _, counts1 = timed(torch, ops, fit)
    r2, ms2, peak2, counts2 = timed(torch, ops, fit)
    captures = graphs.captures()[0]
    with eager_graphs(graphs):
        re_, ms_e, _, _ = timed(torch, ops, fit)
    same = all(torch.equal(a, b) for a, b in zip(r1, r2)) and \
        all(torch.equal(a, b) for a, b in zip(r2, re_))
    if captures != 1 or not same or counts1 != want or counts2 != want:
        raise AssertionError(f"kmeans_fit twice: {captures} captures, "
                             f"equal to each other and the eager loop "
                             f"{same}, launches {counts1} / {counts2}")
    cache = {"captures": captures, "first_ms_per_iter": ms1 / KMEANS_ITERS,
             "second_ms_per_iter": ms2 / KMEANS_ITERS,
             "eager_ms_per_iter": ms_e / KMEANS_ITERS,
             "second_peak_mem_gib": peak2, "launches": counts2}
    log(f"[cache] kmeans_fit {KMEANS_N}x{KMEANS_DIM} k={KMEANS_K}, "
        f"{KMEANS_ITERS} iterations, called twice: {captures} capture; "
        f"the second call {cache['second_ms_per_iter']:.3f} ms/iteration "
        f"(the first, capturing, {cache['first_ms_per_iter']:.3f}), the "
        f"eager loop {cache['eager_ms_per_iter']:.3f}; all three equal "
        f"bit for bit")
    del xd
    torch.cuda.empty_cache()
    return [counts1, counts2], {"hybrid": hy, "cache": cache}


# ------------------------------------------------------------ phase 21

# the pool's task: phase 4's digits trainer (256-128-10, 4 shards × 128,
# f32) for POOL_ITERS loop iterations with its spill and model stores on
# ``shared:`` storage, through a Server polling every POOL_POLL_S and two
# worker processes whose idle back-off is capped at POOL_MAX_SLEEP_S
POOL_ARGS = {"sizes": [256, 128, 10], "n_shards": 4, "bunch": 128,
             "max_steps": 6, "patience": 10_000, "seed": 0}
POOL_ITERS, POOL_WORKERS = 6, 2
POOL_POLL_S, POOL_MAX_SLEEP_S = 0.02, 0.05
DIGITS = "lua_mapreduce_tpu_torch.examples.digits.mr_train"
WORDCOUNT_SERVER = ("lua_mapreduce_tpu_torch/examples/wordcount/"
                    "execute_example_server.sh")


def digits_pool_spec(root):
    from lua_mapreduce_tpu_torch.engine import TaskSpec
    return TaskSpec(taskfn=DIGITS, mapfn=DIGITS, partitionfn=DIGITS,
                    reducefn=DIGITS, finalfn=DIGITS,
                    init_args={**POOL_ARGS,
                               "model_store": f"shared:{root}/model"},
                    storage=f"shared:{root}/spill")


def task_bytes(root):
    """A finished task's output files by name: the partition results and
    the model checkpoint with its meta."""
    import re

    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    pat = re.compile(r"^(result\.P\d+|model\.ckpt|model\.meta)$")
    out = {}
    for sub in ("spill", "model"):
        st = get_storage_from(f"shared:{root}/{sub}")
        for name in st.list("*"):
            if pat.match(name):
                out[f"{sub}/{name}"] = st.read_range(name, 0, st.size(name))
    return out


def subprocess_env():
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ,
                PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def start_workers(coord, reports):
    """``execute_worker`` processes on ``coord``, one report file each."""
    return [subprocess.Popen(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.cli.execute_worker",
         coord, "--name", f"pool-w{i}", "--max-iter", "4000",
         "--max-sleep", str(POOL_MAX_SLEEP_S), "--report", path],
        cwd=REPO, env=subprocess_env()) for i, path in enumerate(reports)]


def stop_workers(procs, timeout):
    """Wait up to ``timeout`` s for each worker to leave, then kill it;
    the exit codes (a killed worker's is negative)."""
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return [p.returncode for p in procs]


def _count_words(paths):
    from collections import Counter
    counts = Counter()
    for path in paths:
        with open(path) as f:
            counts.update(f.read().split())
    return counts


def naive_wordcount(paths):
    """Whitespace-split word counts of ``paths``, in one process or, for
    many files, a :func:`host_pool`."""
    if len(paths) < 16:
        return dict(_count_words(paths))
    from collections import Counter
    counts = Counter()
    with host_pool() as pool:
        for part in pool.map(_count_words, [paths[i::HOST_PROCS]
                                            for i in range(HOST_PROCS)]):
            counts.update(part)
    return dict(counts)


def phase_pool(torch, ops, sgd_params):
    """The distributed Server and Worker on the card: (a) the digits
    trainer through a Server over a FileJobStore and two worker processes
    — result files and the final checkpoint byte-equal to the port's
    LocalExecutor on the card, launches summed over the processes equal
    to the code's count; (b) word count (BASELINE config 1) through the
    example's server script with two inline workers, equal to a naive
    count; (c) ``Server(engine="ingraph")`` running ``mr_sgd`` with no
    job inserted, its parameters bit-equal to phase 19's LocalExecutor
    in-graph run."""
    import glob
    import shutil

    import numpy as np

    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.core.constants import MAP_NS, RED_NS
    from lua_mapreduce_tpu_torch.core.serialize import load_record
    from lua_mapreduce_tpu_torch.engine import (LocalExecutor, Server,
                                                TaskSpec)
    from lua_mapreduce_tpu_torch.examples.digits import mr_sgd
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    base = os.path.join(REPO, "build", "smoke-pool")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    zero = dict.fromkeys(ops.KERNELS, 0)
    coord = os.path.join(base, "coord")
    reports = [os.path.join(base, f"worker{i}.json")
               for i in range(POOL_WORKERS)]
    rep = {}

    # (a) the workers start first: their boot overlaps the reference run
    t_spawn = time.time()
    procs = start_workers(coord, reports)
    try:
        local = LocalExecutor(digits_pool_spec(os.path.join(base, "local")),
                              max_iterations=POOL_ITERS + 1)
        local.run()
        want_bytes = task_bytes(os.path.join(base, "local"))
        store = FileJobStore(coord)
        server = Server(store, poll_interval=POOL_POLL_S).configure(
            digits_pool_spec(os.path.join(base, "pool")))
        first_job = {}

        def progress(phase, frac):
            # iteration 1's map jobs, once all are in: when each worker
            # began its first job
            if phase == "map" and frac >= 1 and not first_job:
                for d in store.jobs(MAP_NS):
                    t = (d.get("times") or {}).get("started")
                    if t:
                        w = d["worker"]
                        first_job[w] = min(t, first_job.get(w, t))

        torch.cuda.synchronize()
        ops.reset_launch_counts()
        stats = server.loop(progress=progress)
        torch.cuda.synchronize()
        server_counts = ops.launch_counts()
        codes = stop_workers(procs, 60)
    except BaseException:
        stop_workers(procs, 0)
        raise
    if codes != [0] * POOL_WORKERS:
        raise AssertionError(f"worker processes exited {codes}")
    got_bytes = task_bytes(os.path.join(base, "pool"))
    n_results = sum(n.startswith("spill/") for n in want_bytes)
    if not n_results or got_bytes != want_bytes:
        differ = sorted(n for n in set(want_bytes) | set(got_bytes)
                        if want_bytes.get(n) != got_bytes.get(n))
        raise AssertionError(f"digits pool files differ from the "
                             f"LocalExecutor's: {differ}")
    if local.engine != "store" or server._ingraph.decision.chosen != "store":
        raise AssertionError(f"digits ran on {local.engine} / "
                             f"{server._ingraph.decision.chosen}, not the "
                             f"store plane")
    wreps = [json.load(open(p)) for p in reports]
    worker_counts = {k: sum(r["launches"][k] for r in wreps)
                     for k in ops.KERNELS}
    # per iteration: 4 map jobs × (2 forward + 3 backward products, 1
    # log_softmax) in the workers; the validation loss (2 products, 1
    # log_softmax) in the server's finalfn
    want_w = {**zero, "matmul_f32": POOL_ITERS * 4 * 5,
              "rowwise_softmax": POOL_ITERS * 4}
    want_s = {**zero, "matmul_f32": POOL_ITERS * 2,
              "rowwise_softmax": POOL_ITERS}
    if worker_counts != want_w or server_counts != want_s:
        raise AssertionError(f"pool launches: workers {worker_counts} "
                             f"(expected {want_w}), server {server_counts} "
                             f"(expected {want_s})")
    doc_started = store.get_task()["started"]
    its = stats.iterations
    walls = [1e3 * it.wall_time for it in its]
    lwalls = [1e3 * it.wall_time for it in local.stats.iterations]
    workers = {}
    for r in wreps:
        w = r["worker"]
        workers[w] = {"boot_s": r["ready"] - t_spawn, "jobs": r["jobs"],
                      "rounds": r["rounds"]}
        if w in first_job:
            workers[w]["task_load_s"] = \
                first_job[w] - max(doc_started, r["ready"])
    rep["digits"] = {
        "iterations": len(its), "poll_interval_s": POOL_POLL_S,
        "worker_max_sleep_s": POOL_MAX_SLEEP_S, "workers": workers,
        "first_iteration_ms": walls[0],
        "ms_per_iteration": sum(walls[1:]) / (len(walls) - 1),
        "local_first_iteration_ms": lwalls[0],
        "local_ms_per_iteration": sum(lwalls[1:]) / (len(lwalls) - 1),
        "server_claim_rounds": sum(it.claim_rounds for it in its),
        "server_commit_rounds": sum(it.commit_rounds for it in its),
        "worker_claim_rounds": sum(r["rounds"]["claim"] for r in wreps),
        "worker_commit_rounds": sum(r["rounds"]["commit"] for r in wreps),
        "files_equal": sorted(want_bytes), "launches_workers": worker_counts,
        "launches_server": server_counts}
    d = rep["digits"]
    log(f"[pool] digits 256-128-10, 4x128, {len(its)} iterations, Server "
        f"(poll {POOL_POLL_S} s) + {POOL_WORKERS} worker processes "
        f"(max-sleep {POOL_MAX_SLEEP_S} s): {d['ms_per_iteration']:.1f} "
        f"ms/iteration after the first ({d['first_iteration_ms']:.1f} ms); "
        f"LocalExecutor {d['local_ms_per_iteration']:.1f} ms/iteration "
        f"({d['local_first_iteration_ms']:.1f} ms first); "
        f"{len(want_bytes)} files byte-equal ({n_results} results, "
        f"model.ckpt, model.meta)")
    log(f"[pool] rounds: server claim/commit {d['server_claim_rounds']}/"
        f"{d['server_commit_rounds']}, workers {d['worker_claim_rounds']}/"
        f"{d['worker_commit_rounds']}; workers "
        + "; ".join(f"{w}: boot {v['boot_s']:.2f} s, task load "
                    f"{v.get('task_load_s', float('nan')):.2f} s, "
                    f"{v['jobs']} jobs" for w, v in sorted(workers.items()))
        + f"; launches workers {worker_counts}, server {server_counts}")

    # (b) BASELINE config 1: word count through the example's server
    # script (the unchanged user modules of examples/wordcount) with two
    # inline workers, on the card
    wc = os.path.join(base, "wordcount")
    t0 = time.perf_counter()
    out = subprocess.run(
        ["sh", WORDCOUNT_SERVER, wc, "--inline-workers", "2", "--poll",
         str(POOL_POLL_S), "--quiet"], cwd=REPO, env=subprocess_env(),
        capture_output=True, text=True, timeout=600)
    wc_s = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"wordcount server exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    spill = get_storage_from(f"shared:{wc}/spill")
    got = {}
    for name in spill.list("result.P*"):
        for line in spill.lines(name):
            if line.strip():
                k, v = load_record(line.strip())
                got[k] = v[0]
    corpus = sorted(glob.glob(os.path.join(REPO, "examples", "wordcount",
                                           "*.py")))
    if got != naive_wordcount(corpus):
        raise AssertionError("CLI word count differs from the naive count")
    rep["wordcount"] = {"files": len(corpus), "words": len(got),
                        "seconds": wc_s}
    log(f"[pool] word count ({len(corpus)} files, {len(got)} words) "
        f"through {WORDCOUNT_SERVER} --inline-workers 2: equal to the "
        f"naive count, {wc_s:.2f} s with the process start")

    # (c) the in-graph engine on the Server: no job is inserted
    n = SGD_ARGS["max_steps"]
    want_c = {**zero, "matmul_f32": 20 * n, "rowwise_softmax": 4 * n}
    mod = "lua_mapreduce_tpu_torch.examples.digits.mr_sgd"
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    finalfn=mod, init_args={**SGD_ARGS, "device": "cuda"},
                    storage="mem:smoke-sgd-server")
    mem = MemJobStore()
    server = Server(mem, poll_interval=POOL_POLL_S,
                    engine="ingraph").configure(spec)
    stats, ms, _, counts_c = timed(torch, ops, server.loop)
    params = mr_sgd.read_state()["params"]
    inserted = sum(sum(mem.counts(ns).values()) for ns in (MAP_NS, RED_NS))
    equal = all(np.array_equal(params[k], sgd_params[k]) for k in params)
    compiled = sum(it.ingraph_iterations for it in stats.iterations)
    if not equal or inserted or mem.round_counts()["claim"] \
            or compiled != n or counts_c != want_c:
        raise AssertionError(
            f"Server in-graph mr_sgd: parameters bit-equal to phase 19 "
            f"{equal}, jobs inserted {inserted}, compiled iterations "
            f"{compiled} of {n}, launches {counts_c} (expected {want_c})")
    rep["ingraph_server"] = {"iterations": n, "ms": ms,
                             "ms_per_iteration": ms / n,
                             "traces": server._ingraph.engine.traces,
                             "launches": counts_c}
    log(f"[pool] Server(engine='ingraph') mr_sgd, {n} iterations, no job "
        f"inserted: parameters bit-equal to phase 19's LocalExecutor run; "
        f"{ms / n:.2f} ms/iteration with the build; launches {counts_c}")
    return [server_counts, worker_counts, counts_c], rep


# ------------------------------------------------------------ main

# ------------------------------------------------------------ phase 22
#
# transformer_step_moe8 (benchmarks/kernel_bench.py:380-418, :765): the LM
# widths with 8 switch experts, top-1, capacity 2·B·L/E per routing group
MOE = dict(moe_experts=8, moe_capacity=2 * LM_BATCH * LM_SEQ // 8)
# the serving cell's widths with the same 8-expert FFN; prefill routes
# the whole (B, P) prompt as one group, at the same capacity factor 2
MOE_SERVE = dict(moe_experts=8,
                 moe_capacity=2 * SERVE_BATCH * SERVE_PROMPT // 8)
# the mesh step's zigzag and Ulysses forms against the ring's, f32
MESH_FORMS_TOL = 2e-4


def lm_mesh(torch):
    """The world-size-1 (dp, sp) mesh on the card: NCCL, or the run
    fails."""
    import torch.distributed as dist

    from lua_mapreduce_tpu_torch.parallel import make_mesh
    mesh = make_mesh(dp=1, mp=1, device="cuda", axis_names=("dp", "sp"))
    if "nccl" not in dist.get_backend():
        raise AssertionError(f"the card's mesh runs {dist.get_backend()}")
    return mesh


def moe_expert_flop(cfg, steps=1):
    """The expert FFN's f32 products of ``steps`` train steps: per layer
    and routing group two (E·C, d)·(d, d_ff)-sized products forward,
    three times that with the backward."""
    per = 2 * 2 * cfg.moe_experts * cfg.moe_capacity * cfg.d_model * cfg.d_ff
    return 3 * per * cfg.n_layers * steps


def phase_moe_train(torch, ops, mesh, seed=0):
    """transformer_step_moe8 through ``make_train_step(mesh=)`` over the
    dp = sp = 1 NCCL mesh at full width, bf16, SGD(1e-3, momentum 0.9),
    ring attention: a warm-up step, counts zeroed, LM_STEPS timed steps,
    counts read; a profiled repeat gives a step's device time by kernel."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    cfg = tt.TransformerConfig(**LM, **MOE)
    params = {k: v.requires_grad_(True) for k, v in tt.shard_params_moe(
        tt.init_transformer(seed, cfg, dtype=torch.bfloat16, device="cuda"),
        mesh).items()}
    step = tt.make_train_step(cfg, optim.sgd(params.values(), 1e-3,
                                             momentum=0.9), mesh=mesh,
                              attn="ring")
    tok, tgt = tt.shard_batch(mesh, *lm_tokens(torch, cfg.vocab, LM_BATCH,
                                               LM_SEQ, seed))
    first = float(step(params, tok, tgt))                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(params, tok, tgt) for _ in range(LM_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = train_counts(cfg.n_layers, LM_STEPS)
    if counts != want:
        raise AssertionError(f"moe train launches {counts}, expected {want}")
    losses = [first] + [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"moe train loss not finite: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the optimizer's annotation row repeats its kernels' device time
    kernels = [r for r in kernel_profile(torch, lambda: step(params, tok,
                                                             tgt))
               if not r[0].startswith("Optimizer.")]
    dev_ms = sum(k[1] for k in kernels)
    tags = (("flash_fwd", ("wsk::flash_wgmma_kernel", "flash_bf16_kernel")),
            ("flash_bwd_dq", ("wsk::dq_wgmma_kernel", "bfk::dq_kernel")),
            ("flash_bwd_dkv", ("wsk::dkv_wgmma_kernel", "bfk::dkv_kernel")))
    port_ms = {k: sum(r[1] for r in kernels if any(n in r[0] for n in t))
               for k, t in tags}
    seen = {k: sum(r[2] for r in kernels if any(n in r[0] for n in t))
            for k, t in tags}
    gemm = [r for r in kernels if "gemm" in r[0] or "nvjet" in r[0]]
    by_kind = {"port": sum(port_ms.values()),
               "gemm": sum(r[1] for r in gemm)}
    by_kind["other"] = dev_ms - by_kind["port"] - by_kind["gemm"]
    step_ms = dt * 1e3 / LM_STEPS
    tok_s = LM_BATCH * LM_SEQ * LM_STEPS / dt
    expert_tflop = moe_expert_flop(cfg) / 1e12
    r = {"config": f"d{cfg.d_model} h{cfg.n_heads} L{cfg.n_layers} "
                   f"ff{cfg.d_ff} v{cfg.vocab} E{cfg.moe_experts} "
                   f"C{cfg.moe_capacity} top-{cfg.moe_top_k} seq{LM_SEQ} "
                   f"b{LM_BATCH} bf16, ring over a dp = sp = 1 NCCL mesh",
         "steps": LM_STEPS, "step_ms": step_ms, "tokens_per_s": tok_s,
         "expert_tflop_per_step": expert_tflop,
         "expert_tflops": expert_tflop / (step_ms / 1e3),
         "losses": losses, "launches": counts, "peak_mem_gib": peak,
         "profiled_step_device_ms": dev_ms,
         "profiled_step_kernel_ms": port_ms,
         "profiled_step_launches": seen,
         "profiled_step_ms_by_kind": by_kind,
         "profile_complete": seen == {k: v for k, v in
                                      train_counts(cfg.n_layers, 1).items()
                                      if v},
         "device_idle_share": 1 - dev_ms / step_ms,
         "top_kernels": kernels[:16]}
    log(f"[moe train] {r['config']}: {LM_STEPS} timed steps, "
        f"{step_ms:.3f} ms/step, {tok_s:.1f} tokens/s, the expert products "
        f"{expert_tflop:.3f} TFLOP a step ({r['expert_tflops']:.3f} "
        f"TFLOP/s), peak {peak:.2f} GiB; losses {losses[0]:.4f} .. "
        f"{losses[-1]:.4f}; launches {counts}")
    log(f"[moe train] profiled step {dev_ms:.3f} ms on the device (flash "
        f"fwd {port_ms['flash_fwd']:.3f}, dq {port_ms['flash_bwd_dq']:.3f}, "
        f"dkv {port_ms['flash_bwd_dkv']:.3f}; GEMMs {by_kind['gemm']:.3f}, "
        f"other {by_kind['other']:.3f}); idle "
        f"{100 * r['device_idle_share']:.1f}% of the timed step; port "
        f"launches in the trace {seen}")
    for name, ms, n in kernels[:16]:
        log(f"[moe train]   {ms:10.3f} ms {n:6d}x  {name[:90]}")
    del params, step
    torch.cuda.empty_cache()
    return r


def moe_serve_counts(n_layers, n_new, quantized):
    """Launches of one MoE greedy_decode(use_prefill=True): serve_counts
    less the FFN's two q8 projections a layer (the expert stacks stay
    full precision under quantize_lm)."""
    want = serve_counts(n_layers, n_new, False)
    if quantized:
        want["q8"] = (2 * n_layers + 1) * n_new
    return want


def phase_moe_serve(torch, ops, seed=0):
    """The serving cell's widths with 8 experts: greedy_decode(
    use_prefill=True) in bf16, then after quantize_lm with an int8 KV
    cache; prefill ms (best of 3), the captured decode tail per step,
    launches (counts zeroed just before the timed call), tokens equal to
    the eager loop's, and from a profiled repeat the kernel time of a
    decode step and its top kernels. The decode step's time is the
    device timeline from the first replay's start to the last one's end,
    over the replays (``timed_replays``)."""
    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(**SERVE, **MOE_SERVE)
    params = tt.init_transformer(seed, cfg, dtype=torch.bfloat16,
                                 device="cuda")
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(seed + 1)
                           ).cuda()
    b, p_len, n_new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    out = {}
    for tag, quantized in (("bf16", False), ("int8", True)):
        p = tt.quantize_lm(params) if quantized else params
        kw = dict(cfg=cfg, use_prefill=True, kv_q8=quantized)
        tt.greedy_decode(p, prompt, 3, **kw)                # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        graphs.reset_captures()
        with timed_replays(torch, tt) as replays:
            t0 = time.perf_counter()
            toks = tt.greedy_decode(p, prompt, n_new, **kw)
            torch.cuda.synchronize()
            e2e = time.perf_counter() - t0
        counts = ops.launch_counts()
        n_captures, last = graphs.captures()
        replay_ms = replays["ms"] / replays["replays"]
        want = moe_serve_counts(cfg.n_layers, n_new, quantized)
        if n_captures != 1 or counts != want:
            raise AssertionError(f"moe serving {tag}: {n_captures} captures,"
                                 f" launches {counts}, expected {want}")
        with eager_graphs(tt):
            eager = tt.greedy_decode(p, prompt, n_new, **kw)
        if not torch.equal(eager, toks):
            raise AssertionError(f"moe serving {tag}: captured tokens "
                                 f"differ from the eager loop's")
        toks = toks.cpu()
        if toks.shape != (b, p_len + n_new) or \
                int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"moe serving {tag}: bad output")
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tt.prefill(p, prompt, cfg=cfg, total=p_len + n_new)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
        prefill_s = min(pre)
        kernels = kernel_profile(
            torch, lambda: tt.greedy_decode(p, prompt, n_new, **kw))
        pre_kernels = kernel_profile(
            torch, lambda: tt.prefill(p, prompt, cfg=cfg,
                                      total=p_len + n_new))
        step_ms = (sum(k[1] for k in kernels)
                   - sum(k[1] for k in pre_kernels)) / (n_new - 1)
        step_launches = (sum(k[2] for k in kernels)
                         - sum(k[2] for k in pre_kernels)) / (n_new - 1)
        gemv_ms, gemv_launches = gemv_per_step(kernels, pre_kernels,
                                               n_new)
        pre_names = {k[0]: k for k in pre_kernels}
        step_rows = sorted(((k[0], (k[1] - pre_names.get(k[0], (0, 0, 0))[1])
                             / (n_new - 1),
                             (k[2] - pre_names.get(k[0], (0, 0, 0))[2])
                             / (n_new - 1)) for k in kernels),
                           key=lambda r: -r[1])
        r = {"prefill_ms": prefill_s * 1e3, "e2e_ms": e2e * 1e3,
             "capture_ms": last[1], "decode_step_ms": replay_ms,
             "decode_tokens_per_s": b / replay_ms * 1e3,
             "step_kernel_ms": step_ms, "step_kernel_launches": step_launches,
             "step_q8_gemv_ms": gemv_ms,
             "step_q8_gemv_launches": gemv_launches,
             "device_idle_share": 1 - step_ms / replay_ms,
             "launches": counts, "step_top_kernels": step_rows[:8],
             "first_tokens": toks[0, p_len:p_len + 8].tolist()}
        log(f"[moe serving] {tag}: prefill {r['prefill_ms']:.3f} ms, "
            f"captured decode {replay_ms:.4f} ms/step "
            f"({r['decode_tokens_per_s']:.1f} tokens/s; capture "
            f"{last[1]:.3f} ms), {step_ms:.4f} ms of kernels a step over "
            f"{step_launches:.1f} launches (the q8 GEMV {gemv_ms:.4f} ms "
            f"over {gemv_launches:.1f}; idle "
            f"{100 * r['device_idle_share']:.1f}%); end to end "
            f"{r['e2e_ms']:.3f} ms; same tokens as the eager loop; launches "
            f"{counts}")
        for name, ms, n in step_rows[:8]:
            log(f"[moe serving] {tag} a step: {ms:8.4f} ms {n:6.1f}x  "
                f"{name[:80]}")
        out[tag] = r
        del p
    del params
    torch.cuda.empty_cache()
    return out


def phase_moe_check(torch, ops, mesh, seed=5):
    """f32, 2 layers at the LM widths, card against the CPU: three
    free-running MoE train steps (losses within LM_CHECK_RTOL, gradients
    normwise within LM_CHECK_NORM); MoE greedy tokens equal with a
    capacity nothing overflows (the card's captured loop); the mesh step
    at dp = sp = 1 bit-equal to the no-mesh step (ring), zigzag and
    Ulysses within MESH_FORMS_TOL; ZeRO-1 (dense) within LM_CHECK_NORM.
    Launches equal the code's counts."""
    import dataclasses

    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.parallel import zero1 as z1
    from lua_mapreduce_tpu_torch.train import optim
    cfg = tt.TransformerConfig(**{**LM, "n_layers": 2, "max_seq": 256},
                               moe_experts=8, moe_capacity=2 * 2 * 256 // 8)
    p0 = tt.init_transformer(seed, cfg, device="cpu")
    tok, tgt = lm_tokens(torch, cfg.vocab, 2, 256, seed)
    out = {}
    sides = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.detach().clone().to(dev).requires_grad_(True)
             for k, v in p0.items()}
        sides[dev] = (p, tt.make_train_step(cfg, optim.sgd(
            p.values(), LM_CHECK_LR, momentum=0.9)))
    losses, gerrs = [], []
    counts = dict.fromkeys(ops.KERNELS, 0)
    for _ in range(3):
        lc = float(sides["cpu"][1](sides["cpu"][0], tok, tgt))
        ops.reset_launch_counts()
        lg = float(sides["cuda"][1](sides["cuda"][0], tok, tgt))
        for k, v in ops.launch_counts().items():
            counts[k] += v
        losses.append((lg, lc))
        gerrs.append(leafwise_err(
            {k: v.grad for k, v in sides["cuda"][0].items()},
            {k: v.grad for k, v in sides["cpu"][0].items()}))
    rel = max(abs(g - c) / abs(c) for g, c in losses)
    msg = (f"MoE E8 2 layers f32 seq 256 b2, 3 free-running steps: (card, "
           f"CPU) losses {losses}, max relative difference {rel:.3e} "
           f"(limit {LM_CHECK_RTOL}); gradient normwise "
           + " ".join(f"{a:.3e} (worst {w:.3e} in {k})" for a, w, k in gerrs)
           + f" (limit {LM_CHECK_NORM}); launches {counts}")
    if counts != train_counts(2, 3) or rel > LM_CHECK_RTOL or any(
            a > LM_CHECK_NORM or w > LM_CHECK_NORM for a, w, _ in gerrs):
        raise AssertionError(f"moe check {msg}")
    log(f"[moe check] {msg}")
    out["train"] = {"losses_card_cpu": losses, "max_rel_diff": rel,
                    "grad_norm_err": gerrs, "launches": counts}
    # greedy tokens: card (captured loop) against the CPU, no overflow
    dcfg = dataclasses.replace(cfg, moe_capacity=2 * (64 + 16))
    prompt = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(seed))
    want = tt.greedy_decode(p0, prompt, 16, cfg=dcfg, use_prefill=True)
    ops.reset_launch_counts()
    got = tt.greedy_decode({k: v.cuda() for k, v in p0.items()},
                           prompt.cuda(), 16, cfg=dcfg,
                           use_prefill=True).cpu()
    dcounts = ops.launch_counts()
    if not torch.equal(got, want) or dcounts != moe_serve_counts(2, 16,
                                                                  False):
        raise AssertionError(f"moe check: greedy tokens {got[:, 64:]} vs "
                             f"the CPU's {want[:, 64:]}; launches {dcounts}")
    log(f"[moe check] greedy decode (capacity {dcfg.moe_capacity}, no "
        f"overflow), prompt 2 x 64 + 16 new: card tokens equal the CPU's; "
        f"launches {dcounts}")
    out["decode_equal"] = True
    # the mesh step against the no-mesh step, on the card
    mesh_runs = {}
    variants = [("none", cfg, None, "ring", False),
                ("ring", cfg, mesh, "ring", False),
                ("zigzag", cfg, mesh, "zigzag", False),
                ("ulysses", cfg, mesh, "ulysses", False)]
    dense = dataclasses.replace(cfg, moe_experts=0, moe_capacity=0)
    pd0 = tt.init_transformer(seed, dense, device="cpu")
    variants += [("dense", dense, mesh, "ring", False),
                 ("zero1", dense, mesh, "ring", True)]
    td = tt.shard_batch(mesh, tok, tgt)
    for name, c, m, attn, z in variants:
        src = pd0 if c is dense else p0
        p = {k: v.detach().clone().cuda().requires_grad_(True)
             for k, v in src.items()}

        def mk(leaves):
            return optim.sgd(leaves, LM_CHECK_LR, momentum=0.9)
        opt = z1.init_state(mk, p, mesh) if z else mk(p.values())
        step = tt.make_train_step(c, opt, mesh=m, attn=attn, zero1=z)
        ls = [float(step(p, *td)) for _ in range(2)]
        mesh_runs[name] = (ls, {k: v.detach().cpu() for k, v in p.items()})
    base_l, base_p = mesh_runs["none"]
    bit = (mesh_runs["ring"][0] == base_l and all(
        torch.equal(mesh_runs["ring"][1][k], base_p[k]) for k in base_p))
    if not bit:
        raise AssertionError("moe check: the dp = sp = 1 mesh ring step is "
                             "not bit-equal to the no-mesh step")
    forms = {}
    for name, ref, tol in (("zigzag", "none", MESH_FORMS_TOL),
                           ("ulysses", "none", MESH_FORMS_TOL),
                           ("zero1", "dense", LM_CHECK_NORM)):
        (lz, pz), (lr, pr) = mesh_runs[name], mesh_runs[ref]
        a, w, k = leafwise_err(pz, pr)
        dl = max(abs(x - y) / abs(y) for x, y in zip(lz, lr))
        forms[name] = {"loss_rel": dl, "param_norm_err": [a, w, k]}
        if dl > tol or a > tol or w > tol:
            raise AssertionError(f"moe check: {name} parts from {ref}: loss "
                                 f"{dl:.3e}, params {a:.3e} (worst {w:.3e} "
                                 f"in {k}), limit {tol}")
    log(f"[moe check] mesh steps at dp = sp = 1 (NCCL): ring bit-equal to "
        f"the no-mesh step (2 steps, losses and parameters); "
        + "; ".join(f"{n} loss {v['loss_rel']:.3e}, params "
                    f"{v['param_norm_err'][0]:.3e}" for n, v in forms.items())
        + f" (limits {MESH_FORMS_TOL}, ZeRO-1 {LM_CHECK_NORM})")
    out["mesh"] = {"ring_bit_equal": bit, "forms": forms}
    return out


# ------------------------------------------------------------ phase 23
#
# the tensor- and pipeline-parallel steps at the lm_train MHA
# widths (LM: d1024 h16 L8 ff4096 v32768, seq 2048, batch 8, bf16,
# SGD(1e-3, momentum 0.9)); the pipeline in PP_MICRO microbatches, its
# batches read from a make_sharded layout of PP_ROWS token rows in
# PP_SHARDS shards
PP_MICRO, PP_ROWS, PP_SHARDS = 4, 128, 4
# the 3-D step at mp = 1 against the 2-D mesh step, the pipeline at
# pp = 1 against the no-mesh step, f32 on the card: loss (relative) and
# parameters (elementwise rtol = atol), the JAX tests' limits
TP_PP_LOSS_RTOL, TP_PP_PARAMS_TOL = 1e-5, 2e-4


def pp_counts(n_layers, steps, n_micro, n_pp=1):
    """Launches of ``steps`` pipeline steps on one stage, from the code:
    the GPipe grid has n_micro + n_pp − 1 ticks and every tick runs each
    of the stage's n_layers/n_pp layers, bubbles included — one flash
    forward (the lse form, under autograd) and one dq and one dkv a
    layer a tick; the train step's counts with a tick as a
    microbatch."""
    return train_counts(n_layers // n_pp, steps, accum=n_micro + n_pp - 1)


@contextlib.contextmanager
def flash_paths(attention):
    """Record the kernel path of every flash forward and backward call
    (``flash_kernel_path`` / ``flash_bwd_kernel_path``: "tma" for the
    TMA + wgmma kernels, "general" for mma.sync) and the forward's form
    (the lse form or not), by wrapping the module's launchers while the
    context is open."""
    import collections
    paths = {"fwd": collections.Counter(), "bwd": collections.Counter(),
             "fwd_form": collections.Counter()}
    fwd = attention.flash_attention_cuda
    bwd = attention.flash_attention_bwd_cuda

    def rec_fwd(q, k, v, **kw):
        paths["fwd"][attention.flash_kernel_path(q, k, v)] += 1
        paths["fwd_form"]["lse" if kw.get("with_lse") else "nolse"] += 1
        return fwd(q, k, v, **kw)

    def rec_bwd(q, k, v, o, lse, do, *a, **kw):
        paths["bwd"][attention.flash_bwd_kernel_path(
            q, k, v, do.to(q.dtype))] += 1
        return bwd(q, k, v, o, lse, do, *a, **kw)

    attention.flash_attention_cuda = rec_fwd
    attention.flash_attention_bwd_cuda = rec_bwd
    try:
        yield paths
    finally:
        attention.flash_attention_cuda = fwd
        attention.flash_attention_bwd_cuda = bwd


def tp_pp_meshes(torch):
    """The (dp, sp, mp) = (1, 1, 1) and (pp,) = (1,) meshes of the
    running world-size-1 NCCL world, from ``make_multihost_mesh``."""
    import torch.distributed as dist

    from lua_mapreduce_tpu_torch.parallel.multihost import make_multihost_mesh
    m3 = make_multihost_mesh((1, 1, 1), ("dp", "sp", "mp"), device="cuda")
    mpp = make_multihost_mesh((1,), ("pp",), device="cuda")
    if "nccl" not in dist.get_backend():
        raise AssertionError(f"the card's mesh runs {dist.get_backend()}")
    return m3, mpp


def sharded_token_batches(torch, vocab, seed):
    """The pipeline step's batches: PP_ROWS token rows of LM_SEQ + 1
    from the seed, written by ``train.sharding.make_sharded`` in
    PP_SHARDS shards to a ``shared:`` store under a temp directory and
    read back by ``ShardedDataset.batches(host_id=0, n_hosts=1)`` —
    (tokens, targets) CPU tensors of LM_BATCH rows."""
    import tempfile

    import numpy as np

    from lua_mapreduce_tpu_torch.store import get_storage_from
    from lua_mapreduce_tpu_torch.train.sharding import (ShardedDataset,
                                                        make_sharded)
    seq = np.random.RandomState(seed).randint(0, vocab, (PP_ROWS,
                                                         LM_SEQ + 1))
    with tempfile.TemporaryDirectory(prefix="lmr-pp-") as root:
        store = get_storage_from(f"shared:{root}")
        make_sharded(store, "lm", seq[:, :-1].astype(np.int32),
                     seq[:, 1:].astype(np.int32), n_shards=PP_SHARDS)
        ds = ShardedDataset(store, "lm")
        batches = list(ds.batches(LM_BATCH, rng=np.random.RandomState(seed),
                                  host_id=0, n_hosts=1))
    return batches


def timed_lm_steps(torch, ops, step, batches, what, want):
    """A warm-up step on batches[0], counts zeroed, LM_STEPS timed steps
    on the next batches, counts read (must equal ``want``); then a
    profiled step with its device ms by kind and the flash paths of
    every attention call in it. Returns the report and the step's
    top kernels."""
    first = float(step(*batches[0]))                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(*batches[1 + i]) for i in range(LM_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    if counts != want:
        raise AssertionError(f"{what} launches {counts}, expected {want}")
    losses = [first] + [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what} loss not finite: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    from lua_mapreduce_tpu_torch.ops import attention
    with flash_paths(attention) as paths:
        step(*batches[-1])
        torch.cuda.synchronize()
    kernels = [r for r in kernel_profile(torch, lambda: step(*batches[-1]))
               if not r[0].startswith("Optimizer.")]
    dev_ms = sum(k[1] for k in kernels)
    tags = (("flash_fwd", ("wsk::flash_wgmma_kernel", "flash_bf16_kernel")),
            ("flash_bwd_dq", ("wsk::dq_wgmma_kernel", "bfk::dq_kernel")),
            ("flash_bwd_dkv", ("wsk::dkv_wgmma_kernel", "bfk::dkv_kernel")))
    port_ms = {k: sum(r[1] for r in kernels if any(n in r[0] for n in t))
               for k, t in tags}
    seen = {k: sum(r[2] for r in kernels if any(n in r[0] for n in t))
            for k, t in tags}
    gemm = sum(r[1] for r in kernels if "gemm" in r[0] or "nvjet" in r[0])
    by_kind = {"port": sum(port_ms.values()), "gemm": gemm,
               "other": dev_ms - sum(port_ms.values()) - gemm}
    step_ms = dt * 1e3 / LM_STEPS
    per_step = {k: v // LM_STEPS for k, v in want.items() if v}
    # every attention call of the bf16 step takes the TMA + wgmma
    # kernels, its forward in the lse form (autograd keeps the lse)
    want_paths = {"fwd": {"tma": per_step["flash_fwd"]},
                  "bwd": {"tma": per_step["flash_bwd_dq"]},
                  "fwd_form": {"lse": per_step["flash_fwd"]}}
    if {k: dict(v) for k, v in paths.items()} != want_paths:
        raise AssertionError(f"{what}: flash paths {paths}, expected "
                             f"{want_paths}")
    return {"steps": LM_STEPS, "step_ms": step_ms,
            "tokens_per_s": LM_BATCH * LM_SEQ * LM_STEPS / dt,
            "losses": losses, "launches": counts, "peak_mem_gib": peak,
            "flash_paths": {k: dict(v) for k, v in paths.items()},
            "profiled_step_device_ms": dev_ms,
            "profiled_step_kernel_ms": port_ms,
            "profiled_step_launches": seen,
            "profiled_step_ms_by_kind": by_kind,
            "profiled_step_kernels": sum(r[2] for r in kernels),
            "profile_complete": seen == per_step,
            "device_idle_share": 1 - dev_ms / step_ms}, kernels


def psum_call_cost(torch, mesh, n=100):
    """Host and device ms per call of ``collectives.psum`` over the
    one-rank NCCL mesh's ``dp`` axis (a clone and an all-reduce), beside
    the clone alone: ``n`` calls enqueued back to back, the host clock
    around the loop before the synchronise, the whole to the
    synchronise for the device side. Two sizes: the (8, 2048, 1024)
    bf16 activation ``reduce_from`` sums in the 3-D step, and a (1024,)
    f32 vector (a norm's gradient in the mesh step's averaging)."""
    from lua_mapreduce_tpu_torch.parallel import collectives as C
    out = {}
    for tag, x in (("activation", torch.zeros((LM_BATCH, LM_SEQ, 1024),
                                              dtype=torch.bfloat16,
                                              device="cuda")),
                   ("vector", torch.zeros(1024, device="cuda"))):
        for what, fn in (("psum", lambda: C.psum(x, mesh, "dp")),
                         ("clone", lambda: x.detach().clone())):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            out[f"{tag}_{what}"] = {
                "host_ms_per_call": host * 1e3 / n,
                "ms_per_call": (time.perf_counter() - t0) * 1e3 / n}
    log("[tp/pp train] one-rank NCCL psum against a clone, per call "
        "(host enqueue / to the synchronise): " + "; ".join(
            f"{k} {v['host_ms_per_call']:.4f} / {v['ms_per_call']:.4f} ms"
            for k, v in out.items()))
    return out


def phase_tp_pp_train(torch, ops, meshes, mesh2, lm, seed=0):
    """The lm_train MHA configuration at full width through (a) the 2-D
    step over phase 22's dp = sp = 1 mesh (the yardstick, in this
    call), (b) ``make_train_step_3d`` over the (1, 1, 1) NCCL mesh with
    ring attention, and (c) ``make_train_step_pp`` over the (1,) mesh in
    PP_MICRO microbatches on batches from a ``make_sharded`` layout:
    each a warm-up step, LM_STEPS timed steps with their launches, and
    a profiled step (device ms by kind, the flash kernel path of every
    attention call). ``lm`` is phase 10's report."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    m3, mpp = meshes
    cfg = tt.TransformerConfig(**LM)
    fixed = [tuple(x.cuda() for x in lm_tokens(torch, cfg.vocab, LM_BATCH,
                                               LM_SEQ, seed))]
    sharded = sharded_token_batches(torch, cfg.vocab, seed)
    if len(sharded) < LM_STEPS + 2:
        raise AssertionError(f"{len(sharded)} sharded batches")

    def sgd(ps):
        return optim.sgd(ps, 1e-3, momentum=0.9)

    out = {}
    for tag in ("2d_mesh", "3d", "pp"):
        p0 = tt.init_transformer(seed, cfg, dtype=torch.bfloat16,
                                 device="cuda")
        if tag == "2d_mesh":
            params = {k: v.requires_grad_(True) for k, v in p0.items()}
            step = tt.make_train_step(cfg, sgd(params.values()), mesh=mesh2)
            batches = [tt.shard_batch(mesh2, *fixed[0])] * (LM_STEPS + 2)
            want = train_counts(cfg.n_layers, LM_STEPS)
        elif tag == "3d":
            params = {k: v.requires_grad_(True) for k, v in
                      tt.shard_params_3d(p0, m3, cfg).items()}
            step = tt.make_train_step_3d(cfg, m3, sgd(params.values()),
                                         attn="ring")
            batches = [tt.shard_batch(m3, *fixed[0])] * (LM_STEPS + 2)
            want = train_counts(cfg.n_layers, LM_STEPS)
        else:
            params = {k: v.requires_grad_(True) for k, v in
                      tt.shard_params_pp(p0, mpp, cfg).items()}
            step = tt.make_train_step_pp(cfg, mpp, sgd(params.values()),
                                         n_micro=PP_MICRO)
            batches = sharded
            want = pp_counts(cfg.n_layers, LM_STEPS, PP_MICRO)
        del p0
        r, kernels = timed_lm_steps(
            torch, ops, lambda tok, tgt: step(params, tok, tgt), batches,
            f"tp/pp {tag}", want)
        r["config"] = (f"d{cfg.d_model} h{cfg.n_heads} L{cfg.n_layers} "
                       f"ff{cfg.d_ff} v{cfg.vocab} seq{LM_SEQ} b{LM_BATCH} "
                       f"bf16, " + {
                           "2d_mesh": "ring over a dp = sp = 1 NCCL mesh",
                           "3d": "ring over a (dp, sp, mp) = (1, 1, 1) "
                                 "NCCL mesh",
                           "pp": f"GPipe over a (pp,) = (1,) NCCL mesh, "
                                 f"{PP_MICRO} microbatches of "
                                 f"{LM_BATCH // PP_MICRO}"}[tag])
        r["vs_phase10_step"] = r["step_ms"] / lm["mha"]["step_ms"]
        if tag != "2d_mesh":
            r["vs_2d_mesh_step"] = r["step_ms"] / out["2d_mesh"]["step_ms"]
        log(f"[tp/pp train] {tag} {r['config']}: {LM_STEPS} timed steps, "
            f"{r['step_ms']:.3f} ms/step ({r['vs_phase10_step']:.3f}x "
            f"phase 10's step"
            + (f", {r['vs_2d_mesh_step']:.3f}x the 2-D mesh step"
               if tag != "2d_mesh" else "")
            + f"), {r['tokens_per_s']:.1f} tokens/s, peak "
            f"{r['peak_mem_gib']:.2f} GiB; losses {r['losses'][0]:.4f} .. "
            f"{r['losses'][-1]:.4f}; launches {r['launches']}")
        k = r["profiled_step_kernel_ms"]
        bk = r["profiled_step_ms_by_kind"]
        log(f"[tp/pp train] {tag}: profiled step "
            f"{r['profiled_step_device_ms']:.3f} ms on the device in "
            f"{r['profiled_step_kernels']} kernels (flash fwd "
            f"{k['flash_fwd']:.3f}, dq {k['flash_bwd_dq']:.3f}, dkv "
            f"{k['flash_bwd_dkv']:.3f}; GEMMs {bk['gemm']:.3f}, other "
            f"{bk['other']:.3f}); idle "
            f"{100 * r['device_idle_share']:.1f}% of the timed step; port "
            f"launches in the trace {r['profiled_step_launches']}"
            f"{'' if r['profile_complete'] else ' (partial trace)'}; flash "
            f"paths {r['flash_paths']}")
        for name, ms, n in kernels[:12]:
            log(f"[tp/pp train] {tag}   {ms:10.3f} ms {n:6d}x  {name[:90]}")
        r["top_kernels"] = kernels[:12]
        out[tag] = r
        del params, step, batches
        torch.cuda.empty_cache()
    out["psum_call_cost"] = psum_call_cost(torch, mesh2)
    return out


def phase_tp_pp_check(torch, ops, meshes, mesh2, seed=5):
    """f32 at 2 layers of the LM widths (seq 256, batch 2), SGD with
    momentum at LM_CHECK_LR: three free-running steps of the 3-D step
    (1, 1, 1) and of the pipeline (pp = 1, 2 microbatches) on the card
    against the no-mesh step on the CPU — the same function (the CPU
    tests hold the forms to it on gloo worlds) through the plain
    versions: each step's loss within LM_CHECK_RTOL, its gradient and
    update normwise within LM_CHECK_NORM. On the card the 3-D step
    equals the 2-D mesh step and the pipeline the no-mesh step within
    TP_PP_LOSS_RTOL / TP_PP_PARAMS_TOL (two steps). Launches equal the
    code's counts."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    m3, mpp = meshes
    cfg = tt.TransformerConfig(**{**LM, "n_layers": 2, "max_seq": 256})
    p0 = tt.init_transformer(seed, cfg, device="cpu")
    tok, tgt = lm_tokens(torch, cfg.vocab, 2, 256, seed)

    def sgd(ps):
        return optim.sgd(ps, LM_CHECK_LR, momentum=0.9)

    def build(form, dev):
        src = {k: v.detach().clone().to(dev) for k, v in p0.items()}
        if form == "3d":
            src = tt.shard_params_3d(src, m3, cfg)
        elif form == "pp":
            src = tt.shard_params_pp(src, mpp, cfg)
        p = {k: v.requires_grad_(True) for k, v in src.items()}
        opt = sgd(p.values())
        if form == "3d":
            return p, opt, tt.make_train_step_3d(cfg, m3, opt)
        if form == "pp":
            return p, opt, tt.make_train_step_pp(cfg, mpp, opt, n_micro=2)
        if form == "2d_mesh":
            return p, opt, tt.make_train_step(cfg, opt, mesh=mesh2)
        return p, opt, tt.make_train_step(cfg, opt)

    def canonical(form, tree):
        if form == "3d":
            return tt.unshard_params_3d(tree, cfg, m3)
        if form == "pp":
            return tt.unstack_params_pp(tree, cfg, mpp)
        return tree

    out = {}
    cpu_p, cpu_opt, cpu_step = build("none", "cpu")
    cpu_runs = []
    for _ in range(3):
        loss = float(cpu_step(cpu_p, tok, tgt))
        cpu_runs.append((loss, {k: v.grad.clone() for k, v in cpu_p.items()},
                         {k: -LM_CHECK_LR * cpu_opt.state[v]["momentum_buffer"]
                          for k, v in cpu_p.items()}))
    for form, want_counts in (("3d", train_counts(2, 3)),
                              ("pp", pp_counts(2, 3, 2))):
        p, opt, step = build(form, "cuda")
        losses, gerrs, uerrs = [], [], []
        counts = dict.fromkeys(ops.KERNELS, 0)
        td = (tok.cuda(), tgt.cuda())
        for lc, gc, uc in cpu_runs:
            ops.reset_launch_counts()
            lg = float(step(p, *td))
            for k, v in ops.launch_counts().items():
                counts[k] += v
            losses.append((lg, lc))
            gerrs.append(leafwise_err(canonical(form, {
                k: v.grad for k, v in p.items()}), gc))
            uerrs.append(leafwise_err(canonical(form, {
                k: -LM_CHECK_LR * opt.state[v]["momentum_buffer"]
                for k, v in p.items()}), uc))
        rel = max(abs(g - c) / abs(c) for g, c in losses)
        msg = (f"{form} 2 layers f32 seq 256 b2, 3 free-running steps: "
               f"(card, CPU) losses {losses}, max relative difference "
               f"{rel:.3e} (limit {LM_CHECK_RTOL}); gradient normwise "
               + " ".join(f"{a:.3e} (worst {w:.3e} in {k})"
                          for a, w, k in gerrs)
               + "; update normwise "
               + " ".join(f"{a:.3e} (worst {w:.3e} in {k})"
                          for a, w, k in uerrs)
               + f" (limit {LM_CHECK_NORM}); launches {counts}")
        if counts != want_counts or rel > LM_CHECK_RTOL or any(
                a > LM_CHECK_NORM or w > LM_CHECK_NORM
                for a, w, _ in gerrs + uerrs):
            raise AssertionError(f"tp/pp check {msg} (launches expected "
                                 f"{want_counts})")
        log(f"[tp/pp check] {msg}")
        out[form] = {"losses_card_cpu": losses, "max_rel_diff": rel,
                     "grad_norm_err": gerrs, "update_norm_err": uerrs,
                     "launches": counts}
        del p, opt, step
    # on the card: the 3-D form against the 2-D mesh step, the pipeline
    # against the no-mesh step, two steps each
    runs = {}
    for form in ("3d", "2d_mesh", "pp", "none"):
        p, _, step = build(form, "cuda")
        td = (tok.cuda(), tgt.cuda())
        if form in ("3d", "2d_mesh"):
            td = tt.shard_batch(m3 if form == "3d" else mesh2, *td)
        ls = [float(step(p, *td)) for _ in range(2)]
        runs[form] = (ls, {k: v.detach().cpu() for k, v in
                           canonical(form, p).items()})
        del p, step
    pairs = {}
    for form, ref in (("3d", "2d_mesh"), ("pp", "none")):
        (lf, pf), (lr, pr) = runs[form], runs[ref]
        dl = max(abs(x - y) / abs(y) for x, y in zip(lf, lr))
        worst = max(float(((pf[k] - pr[k]).abs() - TP_PP_PARAMS_TOL
                           * pr[k].abs()).max()) for k in pr)
        pairs[f"{form}_vs_{ref}"] = {"loss_rel": dl,
                                     "param_excess_over_atol": worst}
        if dl > TP_PP_LOSS_RTOL or worst > TP_PP_PARAMS_TOL:
            raise AssertionError(
                f"tp/pp check: {form} parts from {ref} on the card: loss "
                f"{dl:.3e} (limit {TP_PP_LOSS_RTOL}), params max(|d| − "
                f"rtol·|ref|) {worst:.3e} (limit {TP_PP_PARAMS_TOL})")
    log("[tp/pp check] on the card, 2 steps: " + "; ".join(
        f"{n} loss {v['loss_rel']:.3e}, params max(|d| − rtol·|ref|) "
        f"{v['param_excess_over_atol']:.3e}" for n, v in pairs.items())
        + f" (limits {TP_PP_LOSS_RTOL}, {TP_PP_PARAMS_TOL})")
    out["card_pairs"] = pairs
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 24

# (a) the pool's digits task over the new data plane: pipelined shuffle
# (pre_merge over 2..8 runs), v2 spills on an ``object:`` bucket, every
# process under one seeded LMR_FAULT_PLAN of data-plane and coord-RPC
# faults (max_per_key 2 < the default retry budget of 3: every burst is
# absorbed, so no job runs twice), traced
DP_FAULT_PLAN = ("seed=24;transient=0.04;torn=0.08;error_after_write=0.12;"
                 "rpc_transient=0.03;max_per_key=2")
# (b) word count at the reference's Europarl v7 shape (BASELINE.md:3-7):
# 197 files of ≤10,000 lines, ~25 words a line; here a Zipf vocabulary
# (100,000 words, exponent 1.1) drawn from the seed, the example's
# 15-way FNV partitioner. Pure-Python map and reduce threads share one
# GIL (0.11 s a line a file on the H100 machine), so the published
# 10,000 lines would take ~19 min here; the lines are cut to WC_LINES
# (printed as a cut). Phase 26(b) runs the published shape through the
# native C++ map and merges.
WC_FILES, WC_LINES_PUBLISHED, WC_LINES = 197, 10_000, 250
# phase 24(b)'s Python path runs fewer files: its map and pre-merge jobs
# cost the same at any line count, and phase 26(b) carries the published
# 197 files through the native plane
WC_FILES_PY = 48
WC_WORDS_PER_LINE, WC_VOCAB, WC_ZIPF = 25, 100_000, 1.1
WC_DEVICE = "cuda"          # the workers' device (the task asks for it)
WC_MODULES = ("examples.wordcount.taskfn", "examples.wordcount.mapfn",
              "examples.wordcount.partitionfn", "examples.wordcount.reducefn")


HOST_PROCS = min(8, os.cpu_count() or 1)


def host_pool():
    """A pool of HOST_PROCS processes for the host-only set-up and
    checks of phases 24(b) and 26(b)."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        HOST_PROCS, mp_context=multiprocessing.get_context("spawn"))


@functools.lru_cache(maxsize=2)
def _vocabulary(seed):
    """WC_VOCAB words of 2-11 seeded letters and a digit, and the Zipf
    cdf over them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 12, WC_VOCAB)
    chars = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                               int(lens.sum())))
    ends = np.cumsum(lens)
    words = [chars[e - n:e] + str(i % 7)
             for i, (n, e) in enumerate(zip(lens.tolist(), ends.tolist()))]
    cdf = np.cumsum(1.0 / np.arange(1, WC_VOCAB + 1) ** WC_ZIPF)
    return words, cdf / cdf[-1]


def _write_split(args):
    """One corpus file: its words drawn from the file's own stream
    ``(seed, f)``, so the files can be written in any order."""
    import numpy as np
    root, f, lines, seed, name = args
    words, cdf = _vocabulary(seed)
    w = WC_WORDS_PER_LINE
    ids = np.minimum(np.searchsorted(
        cdf, np.random.default_rng([seed, f]).random(lines * w)),
        WC_VOCAB - 1)
    toks = [words[i] for i in ids]
    path = os.path.join(root, name.format(f))
    with open(path, "w") as fh:
        fh.write("\n".join(" ".join(toks[i:i + w])
                           for i in range(0, len(toks), w)) + "\n")
    return path


def europarl_corpus(root, n_files, lines, seed=0,
                    name="europarl-{:03d}.txt"):
    """``n_files`` text files of ``lines`` lines of WC_WORDS_PER_LINE
    words drawn from a Zipf distribution over a seeded vocabulary,
    named ``name.format(i)``, written by :func:`host_pool`."""
    os.makedirs(root, exist_ok=True)
    with host_pool() as pool:
        return list(pool.map(_write_split, [(root, f, lines, seed, name)
                                            for f in range(n_files)]))


def result_bytes(spec):
    """A task's ``result.P*`` files by name, read through ``spec``."""
    import re

    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    st = get_storage_from(spec)
    return {n: st.read_range(n, 0, st.size(n)) for n in st.list("result.P*")
            if re.match(r"^result\.P\d+$", n)}


def result_counts(res):
    """A word count's ``{word: count}`` from its result files' bytes."""
    from lua_mapreduce_tpu_torch.core.serialize import load_record
    got = {}
    for data in res.values():
        for line in data.decode("utf-8").splitlines():
            if line.strip():
                k, v = load_record(line)
                got[k] = v[0]
    return got


def dataplane_spec(root, **args):
    from lua_mapreduce_tpu_torch.engine import TaskSpec
    return TaskSpec(taskfn=DIGITS, mapfn=DIGITS, partitionfn=DIGITS,
                    reducefn=DIGITS, finalfn=DIGITS,
                    init_args={**POOL_ARGS, **args,
                               "model_store": f"shared:{root}/model"},
                    storage=f"object:{root}/spill")


def start_dataplane_workers(coord, reports, extra=(), env=None):
    return [subprocess.Popen(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.cli.execute_worker",
         coord, "--name", f"dp-w{i}", "--max-iter", "4000",
         "--max-sleep", str(POOL_MAX_SLEEP_S), "--report", path, "--trace",
         *(a.format(i=i) for a in extra)],
        cwd=REPO, env=env or subprocess_env())
        for i, path in enumerate(reports)]


def recording_drops(store, seen):
    """Record each namespace's WRITTEN job ids (with the iteration the
    tracer is on) when the Server drops it at a loop rollover."""
    from lua_mapreduce_tpu_torch.core.constants import Status
    drop = store.drop_ns

    def drop_ns(ns):
        it = int((store.get_task() or {}).get("iteration", 0))
        seen.setdefault(it, []).extend(
            (ns, d["_id"]) for d in store.jobs(ns)
            if d["status"] == Status.WRITTEN)
        return drop(ns)
    store.drop_ns = drop_ns


def profile_names(path):
    """(host annotation names, kernel names) of a torch profile trace."""
    events = json.load(open(path))["traceEvents"]
    user = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    kern = {e["name"] for e in events if e.get("cat") == "kernel"}
    return user, kern


def phase_dataplane(torch, ops, pool):
    """The host plane's first A6b half on the card: (a) phase 21's digits
    task through ``Server(FileJobStore, pipeline=True, premerge_min_runs
    =2, segment_format="v2")`` and two ``execute_worker --trace``
    processes on ``object:`` spill under one LMR_FAULT_PLAN: result files
    and the checkpoint byte-equal to phase 21's LocalExecutor run,
    launches summed over the processes equal to the code's, the faults
    the plan fired equal to the ``faults_injected`` counted, retries
    taken, and an unbroken claim → body → commit chain for every
    committed job of every iteration; (b) word count at Europarl's
    shape through ``cli.execute_server --pipeline --segment-format v2
    --trace --inline-workers 4`` on ``object:``: counts equal to a naive
    count, result bytes equal to a barrier v1 run, the pre-merge overlap
    from the spans, the Chrome trace exported under ``build/``; (c) one
    iteration of (a)'s server with ``--trace --profile`` in the workers
    and the server: the span names are rows of the torch profiles
    beside the B1/B2 kernel rows."""
    import shutil

    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.engine import LocalExecutor, Server, TaskSpec
    from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
    from lua_mapreduce_tpu_torch.faults.wrappers import active_plan
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    from lua_mapreduce_tpu_torch.trace.span import Tracer, install_tracer
    from lua_mapreduce_tpu_torch.utils.profiling import device_trace
    base = os.path.join(REPO, "build", "smoke-dataplane")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    zero = dict.fromkeys(ops.KERNELS, 0)
    rep = {"fault_plan": DP_FAULT_PLAN}
    want_bytes = task_bytes(os.path.join(REPO, "build", "smoke-pool",
                                         "local"))
    runs = []

    # (a) the digits pool over the new data plane
    root = os.path.join(base, "pool")
    coord = os.path.join(base, "coord")
    reports = [os.path.join(base, f"worker{i}.json")
               for i in range(POOL_WORKERS)]
    env = dict(subprocess_env(), LMR_FAULT_PLAN=DP_FAULT_PLAN)
    procs = start_dataplane_workers(coord, reports, env=env)
    os.environ["LMR_FAULT_PLAN"] = DP_FAULT_PLAN
    install_tracer(Tracer())
    committed = {}
    try:
        # the snapshot comes first: loading the task (its init) already
        # touches the model store under the plan
        c0 = COUNTERS.snapshot()
        plan = active_plan()
        raw = FileJobStore(coord)
        recording_drops(raw, committed)
        server = Server(raw, poll_interval=POOL_POLL_S, pipeline=True,
                        premerge_min_runs=2, segment_format="v2"
                        ).configure(dataplane_spec(root))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        stats = server.loop()
        torch.cuda.synchronize()
        server_counts = ops.launch_counts()
        server_delta = COUNTERS.delta(c0, COUNTERS.snapshot())
        server_fired = plan.total_fired()
        codes = stop_workers(procs, 60)
    except BaseException:
        stop_workers(procs, 0)
        raise
    finally:
        install_tracer(None)
        os.environ.pop("LMR_FAULT_PLAN", None)
    if codes != [0] * POOL_WORKERS:
        raise AssertionError(f"data-plane worker processes exited {codes}")
    final_it = len(stats.iterations)
    from lua_mapreduce_tpu_torch.core.constants import (MAP_NS, PRE_NS,
                                                        RED_NS, Status)
    committed.setdefault(final_it, []).extend(
        (ns, d["_id"]) for ns in (MAP_NS, PRE_NS, RED_NS)
        for d in raw.jobs(ns) if d["status"] == Status.WRITTEN)
    got_bytes = {}
    for sub, spec in (("spill", f"object:{root}/spill"),
                      ("model", f"shared:{root}/model")):
        st = get_storage_from(spec)
        for name in st.list("*"):
            if name.startswith("result.P") and name.count(".") == 1 or \
                    name in ("model.ckpt", "model.meta"):
                got_bytes[f"{sub}/{name}"] = st.read_range(name, 0,
                                                           st.size(name))
    if got_bytes != want_bytes:
        differ = sorted(n for n in set(want_bytes) | set(got_bytes)
                        if want_bytes.get(n) != got_bytes.get(n))
        raise AssertionError(f"data-plane digits files differ from phase "
                             f"21's LocalExecutor: {differ}")
    wreps = [json.load(open(p)) for p in reports]
    worker_counts = {k: sum(r["launches"][k] for r in wreps)
                     for k in ops.KERNELS}
    want_w = {**zero, "matmul_f32": POOL_ITERS * 4 * 5,
              "rowwise_softmax": POOL_ITERS * 4}
    want_s = {**zero, "matmul_f32": POOL_ITERS * 2,
              "rowwise_softmax": POOL_ITERS}
    if worker_counts != want_w or server_counts != want_s:
        raise AssertionError(f"data-plane launches: workers {worker_counts}"
                             f" (expected {want_w}), server {server_counts} "
                             f"(expected {want_s})")
    runs += [worker_counts, server_counts]
    counters = {k: server_delta.get(k, 0)
                + sum(r["counters"].get(k, 0) for r in wreps)
                for k in ("faults_injected", "retries", "retry_exhausted",
                          "build_verified", "infra_releases")}
    fired = server_fired + sum(sum(r["faults_fired"].values())
                               for r in wreps)
    by_kind = {}
    for d in [dict(plan.fired)] + [r["faults_fired"] for r in wreps]:
        for k, v in d.items():
            by_kind[k] = by_kind.get(k, 0) + v
    if counters["faults_injected"] != fired or not fired:
        raise AssertionError(
            f"faults_injected {counters['faults_injected']} != the plan's "
            f"fired faults {fired} (server {server_delta.get('faults_injected', 0)}"
            f"/{server_fired}, workers "
            f"{[(r['counters'].get('faults_injected', 0), r['faults_fired']) for r in wreps]})")
    if counters["retries"] <= 0:
        raise AssertionError("no store retry under the fault plan")
    col = TraceCollection.from_store(get_storage_from(f"object:{root}/spill"))
    n_jobs, problems = 0, []
    for it, jobs in sorted(committed.items()):
        sub = TraceCollection([s for s in col.spans if s.get("it") == it])
        problems += [f"it{it} {p}" for p in sub.check_complete(jobs)]
        n_jobs += len(jobs)
    if problems or n_jobs < POOL_ITERS * 5:
        raise AssertionError(f"trace chains: {n_jobs} committed jobs, "
                             f"broken: {problems[:5]}")
    its = stats.iterations
    walls = [1e3 * it.wall_time for it in its]
    rep["digits"] = {
        "iterations": len(its), "first_iteration_ms": walls[0],
        "ms_per_iteration": sum(walls[1:]) / (len(walls) - 1),
        "phase21_pool_ms_per_iteration": pool["digits"]["ms_per_iteration"],
        "phase21_local_ms_per_iteration":
            pool["digits"]["local_ms_per_iteration"],
        "premerge_jobs": sum(it.premerge.count for it in its),
        "overlap_fraction": [it.overlap_fraction for it in its],
        "faults_fired": fired, "faults_by_kind": by_kind,
        "counters": counters, "trace_spans": len(col.spans),
        "committed_jobs_with_complete_chains": n_jobs,
        "files_equal": sorted(want_bytes),
        "launches_workers": worker_counts, "launches_server": server_counts}
    d = rep["digits"]
    log(f"[dataplane] digits 256-128-10, 4x128, {len(its)} iterations, "
        f"pipelined (pre_merge {d['premerge_jobs']} jobs) v2 on object:, "
        f"2 traced worker processes under LMR_FAULT_PLAN: "
        f"{d['ms_per_iteration']:.1f} ms/iteration after the first "
        f"({d['first_iteration_ms']:.1f} ms); phase 21's pool "
        f"{d['phase21_pool_ms_per_iteration']:.1f}, its LocalExecutor "
        f"{d['phase21_local_ms_per_iteration']:.1f} ms/iteration; "
        f"{len(want_bytes)} files byte-equal to phase 21's LocalExecutor")
    log(f"[dataplane] faults fired {fired} {by_kind} = faults_injected "
        f"{counters['faults_injected']}; retries {counters['retries']}, "
        f"readback-verified builds {counters['build_verified']}, retry "
        f"budgets exhausted {counters['retry_exhausted']}; {n_jobs} "
        f"committed jobs, every claim -> body -> commit chain complete "
        f"({len(col.spans)} spans); launches workers {worker_counts}, "
        f"server {server_counts}")

    # (b) word count at Europarl's shape through the CLI
    wc = os.path.join(base, "wordcount")
    t0 = time.perf_counter()
    files = europarl_corpus(os.path.join(wc, "corpus"), WC_FILES_PY,
                            WC_LINES)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.cli.execute_server",
         "mem", *WC_MODULES, "--combinerfn", "examples.wordcount.reducefn",
         "--storage", f"object:{wc}/spill", "--init-arg",
         "files=" + os.pathsep.join(files), "--init-arg",
         f"device={WC_DEVICE}", "--inline-workers", "4",
         "--pipeline", "--segment-format", "v2", "--trace",
         "--engine", "store", "--poll", str(POOL_POLL_S), "--quiet"],
        cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"word count server exited {out.returncode}:"
                             f"\n{out.stderr[-3000:]}")
    t0 = time.perf_counter()
    bar = LocalExecutor(TaskSpec(
        taskfn=WC_MODULES[0], mapfn=WC_MODULES[1], partitionfn=WC_MODULES[2],
        reducefn=WC_MODULES[3], combinerfn=WC_MODULES[3],
        init_args={"files": files, "device": WC_DEVICE},
        storage=f"object:{wc}/barrier"),
        map_parallelism=4, engine="store")
    bar.run()
    bar_s = time.perf_counter() - t0
    got_res = result_bytes(f"object:{wc}/spill")
    if not got_res or got_res != result_bytes(f"object:{wc}/barrier"):
        raise AssertionError("pipelined v2 word count result files differ "
                             "from the barrier v1 run's")
    got = result_counts(got_res)
    t0 = time.perf_counter()
    naive = naive_wordcount(files)
    naive_s = time.perf_counter() - t0
    if got != naive:
        raise AssertionError("pipelined word count differs from the naive "
                             "count")
    chrome = os.path.join(base, "wordcount.chrome.json")
    tr = subprocess.run(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.trace",
         f"object:{wc}/spill", "--export", chrome, "--format", "json"],
        cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=300)
    if tr.returncode:
        raise AssertionError(f"trace CLI exited {tr.returncode}: "
                             f"{tr.stderr[-2000:]}")
    trep = json.loads(tr.stdout)
    phases = {r["phase"]: r for r in trep["phases"]}
    n_words = sum(naive.values())
    rep["wordcount"] = {
        "files": WC_FILES_PY, "published_files": WC_FILES,
        "lines_per_file": WC_LINES,
        "published_lines_per_file": WC_LINES_PUBLISHED,
        "words": n_words, "distinct_words": len(naive),
        "partitions": len(got_res), "corpus_s": gen_s, "cli_s": cli_s,
        "barrier_local_s": bar_s, "naive_s": naive_s,
        "premerge_overlap_from_spans": trep["premerge_overlap"],
        "phases": phases, "spans": trep["spans"], "chrome_trace": chrome}
    w = rep["wordcount"]
    log(f"[dataplane] word count at Europarl's shape: {WC_FILES_PY} files "
        f"x {WC_LINES} lines (cut from the published {WC_FILES} x "
        f"{WC_LINES_PUBLISHED}: pure-Python map/reduce threads under one "
        f"GIL; phase 26(b) runs the published shape), {n_words} words, "
        f"{len(naive)} distinct, {len(got_res)} partitions (15-way FNV)")
    log(f"[dataplane] execute_server --pipeline --segment-format v2 "
        f"--trace --inline-workers 4 on object: {cli_s:.2f} s with the "
        f"process start; barrier v1 LocalExecutor (4 threads) "
        f"{bar_s:.2f} s; result bytes equal, counts equal the naive count "
        f"({naive_s:.2f} s); pre-merge overlap from the spans "
        f"{trep['premerge_overlap']}; phases "
        + ", ".join(f"{k} {v['jobs']} jobs {v['window_s']:.2f} s window"
                    for k, v in sorted(phases.items()))
        + f"; Chrome trace {os.path.relpath(chrome, REPO)}")

    # (c) one iteration with --trace --profile: span names in the torch
    # profiles beside the B1/B2 kernel rows
    root1 = os.path.join(base, "profiled")
    coord1 = os.path.join(base, "coord-profiled")
    prof = os.path.join(base, "profile")
    reports1 = [os.path.join(base, f"profiled{i}.json")
                for i in range(POOL_WORKERS)]
    procs = start_dataplane_workers(
        coord1, reports1, extra=("--profile", prof + "/worker{i}"))
    install_tracer(Tracer(annotate=True))
    try:
        server = Server(FileJobStore(coord1), poll_interval=POOL_POLL_S,
                        pipeline=True, premerge_min_runs=2,
                        segment_format="v2").configure(
            dataplane_spec(root1, max_steps=1))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with device_trace(os.path.join(prof, "server")):
            stats1 = server.loop()
        server_counts1 = ops.launch_counts()
        codes = stop_workers(procs, 120)
    except BaseException:
        stop_workers(procs, 0)
        raise
    finally:
        install_tracer(None)
    if codes != [0] * POOL_WORKERS or len(stats1.iterations) != 1:
        raise AssertionError(f"profiled run: workers exited {codes}, "
                             f"{len(stats1.iterations)} iterations")
    b1 = ("matmul_f32_kernel",)
    b2 = ("softmax_warp_kernel", "softmax_regs_kernel",
          "softmax_stream_kernel")
    rows = {}
    for who in [f"worker{i}" for i in range(POOL_WORKERS)] + ["server"]:
        paths = glob_files(os.path.join(prof, who), "*.pt.trace.json")
        if len(paths) != 1:
            raise AssertionError(f"{who}: {len(paths)} profile traces")
        user, kern = profile_names(paths[0])
        rows[who] = {
            "spans": sorted(n for n in user
                            if n.endswith(".body") or n.startswith("phase.")
                            or n.startswith("coord.")
                            or n.startswith("store."))[:12],
            "b1_rows": sum(any(t in k for t in b1) for k in kern),
            "b2_rows": sum(any(t in k for t in b2) for k in kern)}
        want_spans = ({"phase.map", "phase.reduce"} if who == "server"
                      else {"map.body"})
        ran_maps = who == "server" or json.load(
            open(reports1[int(who[-1])]))["launches"]["matmul_f32"] > 0
        if ran_maps and (not want_spans <= user or not rows[who]["b1_rows"]
                         or not rows[who]["b2_rows"]):
            raise AssertionError(f"{who}'s profile lacks spans "
                                 f"{sorted(want_spans - user)} or B1/B2 "
                                 f"rows: {rows[who]}")
    wreps1 = [json.load(open(p)) for p in reports1]
    worker_counts1 = {k: sum(r["launches"][k] for r in wreps1)
                      for k in ops.KERNELS}
    if worker_counts1 != {**zero, "matmul_f32": 4 * 5,
                          "rowwise_softmax": 4} or \
            server_counts1 != {**zero, "matmul_f32": 2,
                               "rowwise_softmax": 1}:
        raise AssertionError(f"profiled run launches: workers "
                             f"{worker_counts1}, server {server_counts1}")
    runs += [server_counts1, worker_counts1]
    rep["profile"] = rows
    log(f"[dataplane] one iteration with --trace --profile: span names "
        f"in the torch profiles beside B1/B2 kernel rows: "
        + "; ".join(f"{w}: {v['spans'][:4]} ... B1 {v['b1_rows']} B2 "
                    f"{v['b2_rows']} kernel names" for w, v in rows.items()))
    return runs, rep


# ------------------------------------------------------------ phase 25

# (a) phase 24's digits pool (pipelined, v2 on ``object:``) with
# replication 2 under phase 24's fault plan plus one placement tag dark
# for the first RECOVERY_BLACKOUT_S seconds of each process's run (its
# plan's clock starts at its first op on a file): the window covers the
# first iterations' reduces and then ends, so copies on the tag outlive
# the sweeps across iteration boundaries and come back mid-run, where
# the server's record of the spills it could not remove keeps them out
# of later iterations. The dark tag is one that neither the model
# store's files nor the partition results sit on: the blackout darkens
# the shuffle plane (primaries and replica copies on that tag), which
# replication protects, and not the files no copy protects.
RECOVERY_BLACKOUT_S = 15.0
# (b) coding 4+2 with the push shuffle, barrier, on ``shared:``: every
# read of the first data block of every stripe fails (the JAX chaos
# suite's _kill_block0_plan). A digits map emits five records (the
# gradient of each parameter and the loss), one per key; a record past
# the frame size is pushed as a frame at once, so the workers' frames
# are set above the largest record (LMR_PUSH_FRAME_KB) and their push
# budget far below it: the records buffer, the pool goes over budget
# and the oldest partitions evict, the rest publish at the map's end as
# one group stripe
CODED_PLAN = ("seed=25;permanent=1;pattern=^0.*^result.*;"
              "max_per_key=100000;latency_ms=0")
CODED_PUSH_BUDGET_MB, CODED_FRAME_KB = 0.05, 16384
# (c) replication 2, barrier, on ``shared:``: when the server publishes
# iteration LOSS_ITER's reduce jobs, every copy of the first reduce
# job's input runs is removed (after discovery, before the insert, so
# the loss races nothing)
LOSS_ITER = 2
# (d) the push shuffle at scale: the CloudSort scenario of the port's
# extsort (examples/extsort/sorttask.py, ~110 B a record) through the
# CLI with push, coding 4+2 and v2 spills on ``object:``, 16 range
# partitions. The published scenario is GB-scale, cut here to 16 x
# 65,536 records (~100 MB); a push budget below a map's ~7 MB of output
# forces evictions
SORT_JOBS, SORT_RECORDS, SORT_PARTS = 16, 65536, 16
SORT_BUDGET_MB = 2.0
SORTTASK = "lua_mapreduce_tpu_torch.examples.extsort.sorttask"


def dark_tag():
    """The smallest placement tag no model-store file and no partition
    result of the digits task sits on."""
    from lua_mapreduce_tpu_torch.engine.placement import NUM_TAGS, tag_of
    from lua_mapreduce_tpu_torch.examples.digits.mr_train import \
        NUM_REDUCERS
    used = {tag_of(n) for n in ["model.ckpt", "model.meta"]
            + [f"result.P{p}" for p in range(NUM_REDUCERS)]}
    return min(t for t in range(NUM_TAGS) if t not in used)


def recording_jobs(store, seen):
    """Record every namespace's job docs when the Server drops it at a
    loop rollover (the last iteration's are read after the run)."""
    drop = store.drop_ns

    def drop_ns(ns):
        seen.extend(dict(d, ns=ns) for d in store.jobs(ns))
        return drop(ns)
    store.drop_ns = drop_ns


def spawn_recovery_workers(base, name, plan=None, worker_args=(),
                           env_extra=None):
    """Start one part's two ``execute_worker`` processes (under the
    fault plan ``plan``, if any, and ``env_extra``) on the part's
    coordination directory; they poll until the part's server publishes
    its task."""
    coord = os.path.join(base, f"{name}-coord")
    reports = [os.path.join(base, f"{name}-worker{i}.json")
               for i in range(POOL_WORKERS)]
    env = dict(subprocess_env(), **(env_extra or {}))
    if plan is not None:
        env["LMR_FAULT_PLAN"] = plan
    procs = start_dataplane_workers(coord, reports, extra=worker_args,
                                    env=env)
    return {"name": name, "coord": coord, "reports": reports,
            "procs": procs, "plan": plan}


def run_recovery_pool(torch, ops, base, workers, spec_of, server_kw,
                      hook=None, engine="auto"):
    """Phase 21's digits task through a ``Server(FileJobStore,
    **server_kw)`` and the part's two worker processes
    (:func:`spawn_recovery_workers`), every process under the part's
    fault plan. ``hook(raw_store, root)`` may instrument the
    coordination store before the run; ``engine`` is the server's
    job-index engine. Returns what the gates read."""
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.core.constants import (MAP_NS, PRE_NS,
                                                        RED_NS)
    from lua_mapreduce_tpu_torch.engine import Server
    from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
    from lua_mapreduce_tpu_torch.faults.wrappers import active_plan
    name, plan, procs = workers["name"], workers["plan"], workers["procs"]
    root = os.path.join(base, name)
    coord, reports = workers["coord"], workers["reports"]
    if plan is not None:
        os.environ["LMR_FAULT_PLAN"] = plan
    jobs = []
    try:
        # the snapshot comes first: the task's init touches the model
        # store under the plan
        c0 = COUNTERS.snapshot()
        splan = active_plan()
        raw = FileJobStore(coord, engine=engine)
        recording_jobs(raw, jobs)
        if hook is not None:
            hook(raw, root)
        server = Server(raw, poll_interval=POOL_POLL_S,
                        **server_kw).configure(spec_of(root))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        stats = server.loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        server_counts = ops.launch_counts()
        server_delta = COUNTERS.delta(c0, COUNTERS.snapshot())
        server_fired = dict(splan.fired) if splan is not None else {}
        codes = stop_workers(procs, 60)
    except BaseException:
        stop_workers(procs, 0)
        raise
    finally:
        os.environ.pop("LMR_FAULT_PLAN", None)
    if codes != [0] * POOL_WORKERS:
        raise AssertionError(f"{name}: worker processes exited {codes}")
    jobs += [dict(d, ns=ns) for ns in (MAP_NS, PRE_NS, RED_NS)
             for d in raw.jobs(ns)]
    wreps = [json.load(open(p)) for p in reports]
    counters = dict(server_delta)
    fired = dict(server_fired)
    for r in wreps:
        for k, v in r["counters"].items():
            counters[k] = counters.get(k, 0) + v
        for k, v in r["faults_fired"].items():
            fired[k] = fired.get(k, 0) + v
    return {"root": root, "stats": stats, "wall_s": wall, "server": server,
            "server_counts": server_counts, "wreps": wreps,
            "counters": counters, "fired": fired, "jobs": jobs}


def hold_recovery_run(ops, name, run, want_bytes, spill_spec):
    """The gates every part of phase 25 shares: the files byte-equal to
    phase 21's LocalExecutor, no job BROKEN or FAILED at the end of its
    iteration, and launches summed over the processes equal to the
    code's — 5 B1 and 1 B2 per map body the workers ran (re-runs
    included), 2 and 1 per iteration in the server's finalfn."""
    from lua_mapreduce_tpu_torch.core.constants import Status
    got = run_files(run["root"], spill_spec)
    if got != want_bytes:
        differ = sorted(n for n in set(want_bytes) | set(got)
                        if want_bytes.get(n) != got.get(n))
        raise AssertionError(f"{name}: files differ from phase 21's "
                             f"LocalExecutor: {differ}")
    bad = [(d["ns"], d["_id"], d["status"]) for d in run["jobs"]
           if d["status"] in (Status.BROKEN, Status.FAILED)]
    if bad:
        raise AssertionError(f"{name}: jobs BROKEN/FAILED: {bad[:5]}")
    wreps = run["wreps"]
    bodies = sum(r["bodies"].get("map", 0) for r in wreps)
    worker_counts = {k: sum(r["launches"][k] for r in wreps)
                     for k in ops.KERNELS}
    n_it = len(run["stats"].iterations)
    if bodies < 4 * POOL_ITERS or n_it != POOL_ITERS:
        raise AssertionError(f"{name}: {bodies} map bodies, {n_it} "
                             f"iterations")
    hold_launches(ops, name, worker_counts, bodies, 0)
    hold_launches(ops, name, run["server_counts"], 0, n_it)
    return bodies, worker_counts


def run_files(root, spill_spec):
    """A digits run's output files by name: the ``result.P*`` files read
    through ``spill_spec(root)``, the model checkpoint and its meta."""
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    got = {}
    for sub, spec in (("spill", spill_spec(root)),
                      ("model", f"shared:{root}/model")):
        st = get_storage_from(spec)
        for n in st.list("*"):
            if n.startswith("result.P") and n.count(".") == 1 or \
                    n in ("model.ckpt", "model.meta"):
                got[f"{sub}/{n}"] = st.read_range(n, 0, st.size(n))
    return got


def hold_launches(ops, name, got, bodies, iterations):
    """The digits task's launches: 5 B1 and 1 B2 per map body (re-runs
    included), 2 and 1 per iteration's finalfn."""
    want = {**dict.fromkeys(ops.KERNELS, 0),
            "matmul_f32": 5 * bodies + 2 * iterations,
            "rowwise_softmax": bodies + iterations}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want} "
                             f"({bodies} map bodies, {iterations} "
                             f"iterations' finalfn)")


def phase_recovery(torch, ops):
    """The lost-file plane and the push shuffle on the card, each part's
    files byte-equal to phase 21's LocalExecutor and its launches the
    code's, re-run map bodies included: (a) replication 2 under phase
    24's fault plan plus a blackout of one placement tag — the blackout
    fired, faults fired equal faults_injected, reads failed over;
    (b) coding 4+2 with the push shuffle under a plan that destroys the
    first data block of every stripe — reduces decode from the
    survivors, maps push frames and evict; (c) total loss of every copy
    of one reduce job's inputs — the server requeues the producing maps,
    the workers re-run them on the card, the reduce then succeeds;
    (d) the port's extsort at 1 M records through ``execute_server
    --push --coding 4+2 --segment-format v2 --inline-workers 4`` on
    ``object:`` — globally sorted, equal to a plain sort of the
    regenerated records and to a push-off barrier v1 run's bytes."""
    import shutil
    base = os.path.join(REPO, "build", "smoke-recovery")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    want_bytes = task_bytes(os.path.join(REPO, "build", "smoke-pool",
                                         "local"))

    # (a) replication under a blackout
    tag = dark_tag()
    plan_a = (f"{DP_FAULT_PLAN};blackout_tag={tag};"
              f"blackout_s={RECOVERY_BLACKOUT_S:g}")
    # every part's workers start now: their boot overlaps part (a)
    spawned = [spawn_recovery_workers(base, "blackout", plan_a,
                                      ("--trace",)),
               spawn_recovery_workers(
                   base, "coded", CODED_PLAN,
                   ("--push-budget-mb", str(CODED_PUSH_BUDGET_MB)),
                   {"LMR_PUSH_FRAME_KB": str(CODED_FRAME_KB)}),
               spawn_recovery_workers(base, "loss")]
    try:
        runs, rep = recovery_parts(torch, ops, base, spawned, tag, plan_a,
                                   want_bytes)
    finally:
        for w in spawned:
            stop_workers(w["procs"], 0)
    # (d) the push shuffle at scale, host only
    rep["extsort"] = phase_extsort(base)
    return runs, rep


def recovery_parts(torch, ops, base, spawned, tag, plan_a, want_bytes):
    """Parts (a)-(c) of :func:`phase_recovery` on the pre-started
    workers."""
    from lua_mapreduce_tpu_torch.core.constants import RED_NS
    from lua_mapreduce_tpu_torch.engine.placement import replica_names
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    rep, runs = {}, []
    run = run_recovery_pool(torch, ops, base, spawned[0], dataplane_spec,
                            dict(pipeline=True, premerge_min_runs=2,
                                 segment_format="v2", replication=2))
    bodies, wc = hold_recovery_run(ops, "(a) blackout", run, want_bytes,
                                   lambda r: f"object:{r}/spill")
    c, f = run["counters"], run["fired"]
    n_fired = sum(f.values())
    if not f.get("blackout") or c.get("faults_injected", 0) != n_fired \
            or c.get("failover_reads", 0) <= 0:
        raise AssertionError(f"(a) blackout: fired {f}, counters "
                             f"{ {k: c.get(k, 0) for k in ('faults_injected', 'failover_reads', 'retries')} }")
    runs += [wc, run["server_counts"]]
    its = run["stats"].iterations
    rep["blackout"] = {
        "plan": plan_a, "dark_tag": tag, "map_bodies": bodies,
        "faults_fired": f, "counters": {k: c.get(k, 0) for k in (
            "faults_injected", "retries", "failover_reads",
            "map_reruns_avoided", "replica_repairs", "map_reruns",
            "infra_releases", "unremoved_spills")},
        "blackout_s": RECOVERY_BLACKOUT_S, "wall_s": run["wall_s"],
        "max_repetitions": max(d.get("repetitions") or 0
                               for d in run["jobs"]),
        "ms_per_iteration": 1e3 * sum(i.wall_time for i in its[1:])
        / (len(its) - 1), "launches_workers": wc,
        "launches_server": run["server_counts"]}
    a = rep["blackout"]
    log(f"[recovery] (a) digits pool pipelined v2 on object:, replication "
        f"2, phase 24's plan + tag {tag} dark for the first "
        f"{RECOVERY_BLACKOUT_S:g} s of a {run['wall_s']:.1f} s run: files "
        f"byte-equal to phase 21's LocalExecutor; faults fired {f} = "
        f"faults_injected {c.get('faults_injected')}; failover reads "
        f"{c.get('failover_reads')}, map re-runs avoided "
        f"{c.get('map_reruns_avoided', 0)}, map re-runs "
        f"{c.get('map_reruns', 0)}, spills the sweeps could not remove "
        f"{c.get('unremoved_spills', 0)}; {bodies} map bodies, jobs charged at "
        f"most {a['max_repetitions']} repetitions; "
        f"{a['ms_per_iteration']:.1f} ms/iteration after the first; "
        f"launches workers {wc}, server {run['server_counts']}")

    # (b) erasure coding with the push shuffle
    run = run_recovery_pool(torch, ops, base, spawned[1], digits_pool_spec,
                            dict(coding="4+2", push=True))
    bodies, wc = hold_recovery_run(ops, "(b) coded push", run, want_bytes,
                                   lambda r: f"shared:{r}/spill")
    c = run["counters"]
    if c.get("decode_reads", 0) <= 0 or c.get("push_frames", 0) <= 0 \
            or c.get("push_evictions", 0) <= 0 or c.get("map_reruns", 0):
        raise AssertionError(f"(b) coded push: counters "
                             f"{ {k: c.get(k, 0) for k in ('decode_reads', 'push_frames', 'push_evictions', 'map_reruns')} }")
    runs += [wc, run["server_counts"]]
    its = run["stats"].iterations
    rep["coded_push"] = {
        "plan": CODED_PLAN, "push_budget_mb": CODED_PUSH_BUDGET_MB,
        "map_bodies": bodies, "faults_fired": run["fired"],
        "counters": {k: c.get(k, 0) for k in (
            "decode_reads", "push_frames", "push_evictions", "map_reruns",
            "map_reruns_avoided", "faults_injected")},
        "ms_per_iteration": 1e3 * sum(i.wall_time for i in its[1:])
        / (len(its) - 1), "launches_workers": wc,
        "launches_server": run["server_counts"]}
    b = rep["coded_push"]
    log(f"[recovery] (b) digits pool, coding 4+2 + push (budget "
        f"{CODED_PUSH_BUDGET_MB} MB), barrier on shared:, block 0 of every"
        f" stripe unreadable: files byte-equal; decode reads "
        f"{c['decode_reads']}, push frames {c['push_frames']}, evictions "
        f"{c['push_evictions']}, map re-runs {c.get('map_reruns', 0)}; "
        f"{b['ms_per_iteration']:.1f} ms/iteration after the first; "
        f"launches workers {wc}, server {run['server_counts']}")

    # (c) total loss: every copy of one reduce job's inputs removed
    lost = {}

    def lose_inputs(raw, root):
        insert = raw.insert_jobs
        spill = unwrap(get_storage_from(f"shared:{root}/spill"))

        def insert_jobs(ns, docs):
            it = int((raw.get_task() or {}).get("iteration", 0))
            if ns == RED_NS and it == LOSS_ITER and not lost and docs:
                files = docs[0]["value"]["files"]
                for name in files:
                    for copy in replica_names(name, 2):
                        spill.remove(copy)
                lost.update(part=docs[0]["value"]["part"],
                            files=list(files))
            return insert(ns, docs)
        raw.insert_jobs = insert_jobs

    run = run_recovery_pool(torch, ops, base, spawned[2], digits_pool_spec,
                            dict(replication=2), hook=lose_inputs)
    bodies, wc = hold_recovery_run(ops, "(c) total loss", run, want_bytes,
                                   lambda r: f"shared:{r}/spill")
    c = run["counters"]
    requeues = [e for e in run["server"].errors
                if e.get("classification") == "spill-lost-requeue"]
    named = sorted({n for e in run["server"].errors
                    for n in e.get("lost_files") or ()})
    reran = bodies - 4 * POOL_ITERS
    if not lost or c.get("map_reruns", 0) < len(lost["files"]) \
            or len(requeues) < len(lost["files"]) or reran < len(
                lost["files"]) or not set(lost["files"]) <= set(named):
        raise AssertionError(
            f"(c) total loss of {lost}: map_reruns "
            f"{c.get('map_reruns', 0)}, requeue entries {len(requeues)}, "
            f"re-run bodies {reran}, lost_files named {named}")
    runs += [wc, run["server_counts"]]
    rep["total_loss"] = {
        "iteration": LOSS_ITER, "partition": lost["part"],
        "lost_files": lost["files"], "lost_files_named": named,
        "map_reruns": c.get("map_reruns", 0), "map_bodies": bodies,
        "rerun_bodies": reran, "infra_releases": c.get("infra_releases", 0),
        "launches_workers": wc, "launches_server": run["server_counts"]}
    log(f"[recovery] (c) digits pool, replication 2, barrier on shared:, "
        f"iteration {LOSS_ITER}: every copy of partition {lost['part']}'s "
        f"{len(lost['files'])} input runs removed; the workers' error "
        f"records named them, the server requeued {c.get('map_reruns')} "
        f"producing maps ({len(requeues)} spill-lost-requeue entries), "
        f"{reran} map bodies re-ran on the card; files byte-equal; "
        f"launches workers {wc} = 5/1 x {bodies} bodies")
    return runs, rep


def phase_extsort(base):
    """Part (d): the port's extsort through the CLI with push, coding
    4+2 and v2 spills on ``object:``, held to a plain sort of the
    regenerated records and to a push-off barrier v1 run's bytes."""
    import importlib

    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.core.serialize import load_record
    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    root = os.path.join(base, "extsort")
    args = {"n_jobs": SORT_JOBS, "records_per_job": SORT_RECORDS,
            "n_partitions": SORT_PARTS, "seed": 0, "device": "cuda"}
    coord = os.path.join(root, "coord")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.cli.execute_server",
         coord, SORTTASK, SORTTASK, SORTTASK, SORTTASK,
         "--storage", f"object:{root}/push",
         *[a for k, v in args.items() for a in ("--init-arg", f"{k}={v}")],
         "--inline-workers", "4", "--push", "--coding", "4+2",
         "--segment-format", "v2", "--push-budget-mb", str(SORT_BUDGET_MB),
         "--engine", "store", "--poll", str(POOL_POLL_S), "--quiet"],
        cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"extsort server exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    it = FileJobStore(coord).get_task()["stats"]
    t0 = time.perf_counter()
    LocalExecutor(TaskSpec(taskfn=SORTTASK, mapfn=SORTTASK,
                           partitionfn=SORTTASK, reducefn=SORTTASK,
                           init_args=dict(args), storage=f"object:{root}/"
                           "staged"), map_parallelism=4,
                  engine="store").run()
    staged_s = time.perf_counter() - t0
    push_res = result_bytes(f"object:{root}/push")
    staged_res = result_bytes(f"object:{root}/staged")
    if len(push_res) != SORT_PARTS or push_res != staged_res:
        raise AssertionError(f"extsort: {len(push_res)} push result files, "
                             f"equal to the staged run's: "
                             f"{push_res == staged_res}")
    keys, records = [], []
    for p in range(SORT_PARTS):
        for line in push_res[f"result.P{p}"].decode("utf-8").splitlines():
            k, v = load_record(line)
            keys.append(k)
            records.append((k, v[0]))
    sort = importlib.import_module(SORTTASK)
    sort.init(args)
    want = sorted(sort.record(0, j, i) for j in range(SORT_JOBS)
                  for i in range(SORT_RECORDS))
    if keys != sorted(keys) or records != want:
        raise AssertionError(f"extsort output: globally sorted "
                             f"{keys == sorted(keys)}, equal to the "
                             f"regenerated records {records == want}")
    n = SORT_JOBS * SORT_RECORDS
    mb = sum(len(v) for v in push_res.values()) / 1e6
    frames, evictions = it.get("push_frames", 0), it.get("push_evictions", 0)
    if frames <= 0 or evictions <= 0 or it.get("decode_reads", 0):
        raise AssertionError(f"extsort: push frames {frames}, evictions "
                             f"{evictions}, decode reads "
                             f"{it.get('decode_reads')}")
    res = {"jobs": SORT_JOBS, "records_per_job": SORT_RECORDS,
           "records": n, "partitions": SORT_PARTS, "result_mb": mb,
           "push_budget_mb": SORT_BUDGET_MB, "cli_s": cli_s,
           "records_per_s": n / cli_s, "staged_local_s": staged_s,
           "push_frames": frames, "push_evictions": evictions}
    log(f"[recovery] (d) extsort {SORT_JOBS} x {SORT_RECORDS} records "
        f"({mb:.1f} MB of results; the published scenario is GB-scale), "
        f"{SORT_PARTS} range partitions, execute_server --push --coding "
        f"4+2 --segment-format v2 --inline-workers 4 on object: (budget "
        f"{SORT_BUDGET_MB} MB): {cli_s:.2f} s with the process start, "
        f"{n / cli_s:.0f} records/s; push frames {frames}, evictions "
        f"{evictions}; globally sorted, equal to the regenerated records "
        f"and to a push-off barrier v1 LocalExecutor run's bytes "
        f"({staged_s:.2f} s)")
    return res


# ------------------------------------------------------------ phase 26
#
# (a) the pool with speculation: a straggler is a job RUNNING longer than
# SPEC_FACTOR × the fleet's map-duration EWMA; the doomed claim lands in
# iteration SPEC_ITER. (b) word count at Europarl's published shape on
# the native map and merges; (c) the native/Python byte parity at a cut.
SPEC_FACTOR, SPEC_ITER = 3.0, 2
NATIVE_PARITY_FILES, NATIVE_PARITY_LINES = 16, 750
BIGTASK = "examples/wordcount_big/bigtask"


def native_wordcount_child(argv, report):
    """Run ``cli.execute_server.main(argv)`` in this process with the
    native entry points wrapped in counters (the index engine of every
    index opened, every native map and every fused native sum or
    pre-merge that served its job), and write the counts to ``report``.
    Run as a child: ``python -c "import chip_smoke;
    chip_smoke.native_wordcount_child(...)"``."""
    from lua_mapreduce_tpu_torch.cli import execute_server
    from lua_mapreduce_tpu_torch.coord import filestore
    from lua_mapreduce_tpu_torch.core import native_wcmap
    from lua_mapreduce_tpu_torch.engine import job
    counts = {"index": {}, "map": [0, 0], "sum": [0, 0], "premerge": [0, 0]}

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def counted(*a, **k):
            ok = real(*a, **k)
            counts[key][0 if ok else 1] += 1
            return ok
        setattr(mod, name, counted)
    wrap(native_wcmap, "run_native_map", "map")
    wrap(job, "native_merge_reduce_sum", "sum")
    wrap(job, "native_premerge", "premerge")
    real_open = filestore.open_index

    def open_index(path, engine="auto"):
        ix = real_open(path, engine)
        kind = type(ix).__name__
        counts["index"][kind] = counts["index"].get(kind, 0) + 1
        return ix
    filestore.open_index = open_index
    t0 = time.perf_counter()
    rc = execute_server.main(argv)
    with open(report, "w") as f:
        json.dump({"rc": rc, "seconds": time.perf_counter() - t0,
                   "counts": counts}, f)


def run_wordcount_child(root, corpus, n_files, env_extra=None):
    """bigtask over ``corpus`` through the CLI in a child process
    (:func:`native_wordcount_child`), pipelined, four inline workers,
    the task on the card, ``shared:`` spill; returns (report, seconds
    with the process start, result bytes by name)."""
    argv = [os.path.join(root, "coord"), BIGTASK, BIGTASK, BIGTASK, BIGTASK,
            "--storage", f"shared:{root}/spill",
            "--init-arg", f"corpus_dir={corpus}",
            "--init-arg", f"n_splits={n_files}",
            "--init-arg", f"device={WC_DEVICE}",
            "--inline-workers", "4", "--pipeline", "--engine", "store",
            "--poll", str(POOL_POLL_S), "--quiet"]
    report = os.path.join(root, "child.json")
    code = (f"import chip_smoke; chip_smoke.native_wordcount_child("
            f"{argv!r}, {report!r})")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(subprocess_env(), **(env_extra or {})),
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"word count child exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    rep = json.load(open(report))
    if rep["rc"]:
        raise AssertionError(f"execute_server returned {rep['rc']}")
    return rep, secs, result_bytes(f"shared:{root}/spill")


def phase_native(torch, ops, pool, dataplane):
    """The native C++ host plane and speculative duplicate leases on the
    card (module docstring, phase 26)."""
    import shutil

    from lua_mapreduce_tpu_torch.coord.idx import NativeJobIndex
    from lua_mapreduce_tpu_torch.core.constants import MAP_NS
    base = os.path.join(REPO, "build", "smoke-native")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    want_bytes = task_bytes(os.path.join(REPO, "build", "smoke-pool",
                                         "local"))
    rep, runs = {}, []

    # (a) speculation over the native index: a doomed claim in iteration
    # SPEC_ITER, right after the server inserts the map jobs and before
    # it opens the phase, so no worker can take that job first
    doomed = {}

    def doom_one(raw, root):
        insert = raw.insert_jobs

        def insert_jobs(ns, docs):
            ids = insert(ns, docs)
            it = int((raw.get_task() or {}).get("iteration", 0))
            if ns == MAP_NS and it == SPEC_ITER and not doomed:
                got = raw.claim_batch(MAP_NS, "doomed", 1)
                doomed.update(job=got[0]["_id"], at=time.time())
            return ids
        raw.insert_jobs = insert_jobs
        if not isinstance(raw._idx(MAP_NS), NativeJobIndex):
            raise AssertionError("FileJobStore(engine='native') opened "
                                 f"{type(raw._idx(MAP_NS)).__name__}")

    t_a = time.perf_counter()
    workers = spawn_recovery_workers(base, "spec")
    try:
        run = run_recovery_pool(torch, ops, base, workers, digits_pool_spec,
                                dict(speculation=SPEC_FACTOR),
                                hook=doom_one, engine="native")
    finally:
        stop_workers(workers["procs"], 0)
    bodies, wc = hold_recovery_run(ops, "(a) speculation", run, want_bytes,
                                   lambda r: f"shared:{r}/spill")
    c = run["counters"]
    reps = {(d["ns"], d["_id"]): d.get("repetitions") or 0
            for d in run["jobs"]}
    if not doomed or c.get("spec_launched", 0) < 1 \
            or c.get("spec_wins", 0) < 1 or any(reps.values()):
        raise AssertionError(
            f"(a) speculation: doomed {doomed}, counters "
            f"{ {k: c.get(k, 0) for k in ('spec_launched', 'spec_wins', 'spec_cancelled')} }"
            f", repetitions {[k for k, v in reps.items() if v]}")
    runs += [wc, run["server_counts"]]
    its = run["stats"].iterations
    walls = [1e3 * i.wall_time for i in its]
    rep["speculation"] = {
        "factor": SPEC_FACTOR, "doomed_iteration": SPEC_ITER,
        "doomed_job": doomed["job"], "map_bodies": bodies,
        "counters": {k: c.get(k, 0) for k in (
            "spec_launched", "spec_wins", "spec_cancelled",
            "spec_wasted_s")},
        "iteration_ms": walls,
        "ms_per_iteration": sum(walls[1:]) / (len(walls) - 1),
        "phase21_pool_ms_per_iteration": pool["digits"]["ms_per_iteration"],
        "seconds": time.perf_counter() - t_a,
        "launches_workers": wc, "launches_server": run["server_counts"]}
    a = rep["speculation"]
    log(f"[native] (a) digits pool on the native index, speculation "
        f"{SPEC_FACTOR:g}, shared:: map job {doomed['job']} of iteration "
        f"{SPEC_ITER} claimed and abandoned; detector opened "
        f"{a['counters']['spec_launched']} duplicate lease(s), clones won "
        f"{a['counters']['spec_wins']}, cancelled "
        f"{a['counters']['spec_cancelled']}; every job at 0 repetitions; "
        f"files byte-equal to phase 21's LocalExecutor; {bodies} map "
        f"bodies (clones counted): launches workers {wc}, server "
        f"{run['server_counts']}")
    log(f"[native] (a) {a['ms_per_iteration']:.1f} ms/iteration after the "
        f"first (iteration {SPEC_ITER}: {walls[SPEC_ITER - 1]:.1f} ms); "
        f"phase 21's pool {a['phase21_pool_ms_per_iteration']:.1f} "
        f"ms/iteration")

    # (b) Europarl's published shape on the native paths
    wc_root = os.path.join(base, "wordcount")
    corpus = os.path.join(wc_root, "corpus")
    t0 = time.perf_counter()
    files = europarl_corpus(corpus, WC_FILES, WC_LINES_PUBLISHED,
                            name="split{:03d}.txt")
    corpus_s = time.perf_counter() - t0
    child, cli_s, res = run_wordcount_child(wc_root, corpus, WC_FILES)
    t0 = time.perf_counter()
    naive = naive_wordcount(files)
    naive_s = time.perf_counter() - t0
    got = result_counts(res)
    n = child["counts"]
    n_red = 15                          # bigtask's NUM_REDUCERS
    if got != naive or n["map"] != [WC_FILES, 0] \
            or n["sum"] != [n_red, 0] or set(n["index"]) != {
                "NativeJobIndex"}:
        raise AssertionError(
            f"(b) word count: counts equal {got == naive}, native map "
            f"[served, refused] {n['map']}, fused sum {n['sum']}, "
            f"pre-merge {n['premerge']}, index engines {n['index']}")
    n_words = sum(naive.values())
    dp_wc = dataplane["wordcount"]
    rep["wordcount"] = {
        "files": WC_FILES, "lines_per_file": WC_LINES_PUBLISHED,
        "words": n_words, "distinct_words": len(naive),
        "partitions": len(res), "corpus_s": corpus_s, "cli_s": cli_s,
        "main_s": child["seconds"], "naive_s": naive_s,
        "words_per_s": n_words / cli_s,
        "native": n,
        "phase24_words_per_s": dp_wc["words"] / dp_wc["cli_s"]}
    b = rep["wordcount"]
    log(f"[native] (b) word count at Europarl's published shape: "
        f"{WC_FILES} files x {WC_LINES_PUBLISHED} lines x "
        f"{WC_WORDS_PER_LINE} words = {n_words} words ({len(naive)} "
        f"distinct), corpus built in {corpus_s:.2f} s (apart); "
        f"execute_server --pipeline --inline-workers 4 on shared:, every "
        f"index native ({n['index']}), native maps {n['map'][0]}/"
        f"{WC_FILES}, fused native sums {n['sum'][0]}/{n_red}, native "
        f"pre-merges {n['premerge'][0]} (refused {n['premerge'][1]}); "
        f"counts equal the naive count ({naive_s:.2f} s)")
    log(f"[native] (b) {cli_s:.2f} s through the CLI with the process "
        f"start ({child['seconds']:.2f} s in main): "
        f"{b['words_per_s'] / 1e6:.2f} M words/s; phase 24(b)'s Python "
        f"path {b['phase24_words_per_s'] / 1e3:.1f} K words/s at "
        f"{WC_LINES} lines a file; no kernel: the device idles")

    # (c) the native bytes equal the Python bytes at a cut
    par = os.path.join(base, "parity")
    pcorpus = os.path.join(par, "corpus")
    europarl_corpus(pcorpus, NATIVE_PARITY_FILES, NATIVE_PARITY_LINES,
                    seed=1, name="split{:03d}.txt")
    nat, nat_s, nat_res = run_wordcount_child(
        os.path.join(par, "native"), pcorpus, NATIVE_PARITY_FILES)
    py, py_s, py_res = run_wordcount_child(
        os.path.join(par, "python"), pcorpus, NATIVE_PARITY_FILES,
        {"LMR_DISABLE_NATIVE": "1"})
    nn, pn = nat["counts"], py["counts"]
    if not nat_res or nat_res != py_res \
            or nn["map"] != [NATIVE_PARITY_FILES, 0] \
            or pn["map"][0] or pn["sum"][0] or pn["premerge"][0] \
            or set(pn["index"]) != {"PyJobIndex"}:
        raise AssertionError(
            f"(c) parity: bytes equal {nat_res == py_res}, native counts "
            f"{nn}, python counts {pn}")
    rep["parity"] = {"files": NATIVE_PARITY_FILES,
                     "lines_per_file": NATIVE_PARITY_LINES,
                     "partitions": len(nat_res), "native_s": nat_s,
                     "python_s": py_s, "native": nn, "python": pn}
    log(f"[native] (c) {NATIVE_PARITY_FILES} files x "
        f"{NATIVE_PARITY_LINES} lines: native run ({nat_s:.2f} s) and "
        f"LMR_DISABLE_NATIVE=1 run ({py_s:.2f} s, Python index, map and "
        f"merges) give byte-equal result files ({len(nat_res)} "
        f"partitions)")
    return runs, rep


# ------------------------------------------------------------ phase 27
#
# the sched plane on phase 21's digits task. (a)'s leader lease lives
# HA_TTL_S seconds; (c)'s flood and its FIFO leg are the JAX package's
# starvation case (tests/test_sched.py:318-382): FLOOD_JOBS one-record
# map jobs, FIFO_BARRIER_JOBS barrier jobs behind them in the FIFO leg,
# FAIR_MEMBERS FairWorker threads
HA_TTL_S = 2.0
FLOOD_JOBS, FIFO_BARRIER_JOBS, FAIR_MEMBERS = 150, 8, 3
SCHED_MOD = "benchmarks.sched_task"


def ha_leader_child(coord, root, jobs_path, args_json):
    """Phase 27(a)'s leader: ``Server(ha=True)`` over ``coord`` running
    the digits task with ``args_json`` on ``object:`` spill, writing each
    namespace's job docs to ``jobs_path`` as it drops them at a loop
    rollover. Run as a child (``python -c "import chip_smoke;
    chip_smoke.ha_leader_child(...)"``); the phase SIGKILLs it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.engine import Server
    raw = FileJobStore(coord)
    jobs = []
    drop = raw.drop_ns

    def drop_ns(ns):
        jobs.extend(dict(d, ns=ns) for d in raw.jobs(ns))
        with open(jobs_path + ".tmp", "w") as f:
            json.dump(jobs, f, default=str)
        os.replace(jobs_path + ".tmp", jobs_path)
        return drop(ns)
    raw.drop_ns = drop_ns
    Server(raw, poll_interval=POOL_POLL_S, ha=True,
           lease_ttl_s=HA_TTL_S).configure(
        dataplane_spec(root, **json.loads(args_json))).loop()


def hold_no_repetitions(name, jobs):
    """Every recorded job doc at zero repetitions, none BROKEN/FAILED."""
    from lua_mapreduce_tpu_torch.core.constants import Status
    bad = [(d["ns"], d["_id"], d["status"], d.get("repetitions"))
           for d in jobs if (d.get("repetitions") or 0)
           or d["status"] in (Status.BROKEN, Status.FAILED)]
    if bad or not jobs:
        raise AssertionError(f"{name}: {len(jobs)} job docs; repeated, "
                             f"BROKEN or FAILED: {bad[:5]}")


def p50_p99(xs):
    import numpy as np
    return ([float(np.percentile(xs, 50)), float(np.percentile(xs, 99))]
            if xs else None)


def sched_ha(torch, ops, base, want_bytes, workers):
    """(a): a SIGKILLed HA leader, its hot standby finishing the task."""
    import signal
    import threading

    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.core.constants import (MAP_NS, PRE_NS,
                                                        RED_NS, Status,
                                                        TaskStatus)
    from lua_mapreduce_tpu_torch.engine import Server
    from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    from lua_mapreduce_tpu_torch.trace.span import Tracer, install_tracer
    coord, root = workers["coord"], os.path.join(base, "ha")
    jobs_path = os.path.join(base, "ha-leader-jobs.json")
    code = (f"import chip_smoke; chip_smoke.ha_leader_child({coord!r}, "
            f"{root!r}, {jobs_path!r}, {json.dumps(POOL_ARGS)!r})")
    leader = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=subprocess_env())
    raw = FileJobStore(coord)
    jobs, res = [], {}
    killed = None
    deadline = time.time() + 300
    try:
        # the leader holds the lease before the standby starts, which
        # would otherwise win the election itself
        while not (raw.pt_get("leader") or {}).get("holder"):
            if leader.poll() is not None or time.time() > deadline:
                raise AssertionError(f"(a) leader never acquired the lease "
                                     f"(exit {leader.poll()})")
            time.sleep(0.01)
        recording_jobs(raw, jobs)
        install_tracer(Tracer())
        c0 = COUNTERS.snapshot()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        standby = Server(raw, poll_interval=POOL_POLL_S, ha=True,
                         lease_ttl_s=HA_TTL_S)

        def run():
            try:
                res["stats"] = standby.loop()
            except BaseException as exc:    # surfaced below
                res["error"] = exc
        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        while killed is None:
            if leader.poll() is not None or not thread.is_alive() \
                    or time.time() > deadline:
                raise AssertionError(f"(a) no kill window: leader exit "
                                     f"{leader.poll()}, standby {res}")
            task = raw.get_task() or {}
            woke = COUNTERS.delta(c0, COUNTERS.snapshot()).get(
                "standby_wakeups", 0)
            it = int(task.get("iteration", 0))
            if woke and it >= 2 and task.get("status") == \
                    TaskStatus.MAP.value:
                c = raw.counts(MAP_NS)
                if 1 <= c[Status.WRITTEN] < sum(c.values()):
                    os.kill(leader.pid, signal.SIGKILL)
                    killed = {"t": time.time(), "iteration": it,
                              "written": c[Status.WRITTEN],
                              "map_jobs": sum(c.values()),
                              "standby_wakeups": woke}
            time.sleep(0.002)
        leader.wait()
        thread.join(timeout=600)
        if thread.is_alive() or "error" in res:
            raise AssertionError(f"(a) the standby did not finish: {res}")
        torch.cuda.synchronize()
        server_counts = ops.launch_counts()
        delta = COUNTERS.delta(c0, COUNTERS.snapshot())
        codes = stop_workers(workers["procs"], 60)
    except BaseException:
        if leader.poll() is None:
            leader.kill()
            leader.wait()
        stop_workers(workers["procs"], 0)
        raise
    finally:
        install_tracer(None)
    if codes != [0] * POOL_WORKERS:
        raise AssertionError(f"(a) worker processes exited {codes}")
    stats = res["stats"]
    its = [i.iteration for i in stats.iterations]
    if its != list(range(killed["iteration"], POOL_ITERS + 1)):
        raise AssertionError(f"(a) the standby ran iterations {its} after "
                             f"a kill in iteration {killed['iteration']}")
    spill = lambda r: f"object:{r}/spill"    # noqa: E731
    got = run_files(root, spill)
    if got != want_bytes:
        raise AssertionError("(a) files differ from phase 21's "
                             "LocalExecutor: " + str(sorted(
                                 n for n in set(got) | set(want_bytes)
                                 if got.get(n) != want_bytes.get(n))))
    # loop-state checkpoints: the digits task keeps its loop state in
    # model.ckpt/model.meta (no save_state hook), so neither run has one
    pool_spill = get_storage_from(
        f"shared:{os.path.join(REPO, 'build', 'smoke-pool', 'pool')}/spill")
    st = unwrap(get_storage_from(spill(root)))
    states = {n: st.read_range(n, 0, st.size(n)) for n in st.list("_state.*")}
    want_states = {n: pool_spill.read_range(n, 0, pool_spill.size(n))
                   for n in pool_spill.list("_state.*")}
    lease = raw.pt_get("leader") or {}
    if states != want_states or delta.get("leader_takeovers", 0) < 1 \
            or lease.get("epoch") != 2 or lease.get("holder") != "":
        raise AssertionError(
            f"(a) _state files {sorted(states)} vs {sorted(want_states)}, "
            f"leader_takeovers {delta.get('leader_takeovers', 0)}, lease "
            f"{lease}")
    with open(jobs_path) as f:
        leader_jobs = json.load(f)
    jobs += [dict(d, ns=ns) for ns in (MAP_NS, PRE_NS, RED_NS)
             for d in raw.jobs(ns)]
    hold_no_repetitions("(a)", leader_jobs + jobs)
    wreps = [json.load(open(p)) for p in workers["reports"]]
    bodies = sum(r["bodies"].get("map", 0) for r in wreps)
    worker_counts = {k: sum(r["launches"][k] for r in wreps)
                     for k in ops.KERNELS}
    if bodies < 4 * POOL_ITERS:
        raise AssertionError(f"(a) {bodies} map bodies")
    hold_launches(ops, "(a) workers", worker_counts, bodies, 0)
    hold_launches(ops, "(a) standby", server_counts, 0, len(its))
    col = TraceCollection.from_store(st)
    takeover = [s for s in col.spans if s["name"] == "leader.takeover"]
    if not takeover:
        raise AssertionError("(a) no leader.takeover span")
    take_s = min(s["t0"] for s in takeover) - killed["t"]
    rep = {"ttl_s": HA_TTL_S, "killed": {k: v for k, v in killed.items()
                                         if k != "t"},
           "kill_to_takeover_s": take_s,
           "standby_iterations": its, "map_bodies": bodies,
           "leader_takeovers": delta.get("leader_takeovers", 0),
           "standby_wakeups": delta.get("standby_wakeups", 0),
           "lease": lease, "files_equal": sorted(got),
           "launches_workers": worker_counts,
           "launches_standby": server_counts}
    log(f"[sched] (a) digits on object: with 2 execute_worker processes: "
        f"the HA leader (child process, TTL {HA_TTL_S:g} s) SIGKILLed in "
        f"iteration {killed['iteration']} with {killed['written']}/"
        f"{killed['map_jobs']} map jobs WRITTEN, after "
        f"{killed['standby_wakeups']} standby wakeup(s); the standby's "
        f"leader.takeover {take_s:.3f} s after the kill; it ran iterations "
        f"{its[0]}-{its[-1]}; lease epoch {lease['epoch']} holder "
        f"{lease['holder']!r}; {len(leader_jobs) + len(jobs)} job docs at "
        f"0 repetitions; files byte-equal to phase 21's LocalExecutor; "
        f"{bodies} map bodies: launches workers {worker_counts}, standby "
        f"{server_counts}")
    return [worker_counts, server_counts], rep


def sched_autotune(torch, ops, base, want_bytes):
    """(b): the task through ``execute_server --autotune`` in-process."""
    from lua_mapreduce_tpu_torch import engine
    from lua_mapreduce_tpu_torch.cli import execute_server
    from lua_mapreduce_tpu_torch.core.constants import (MAP_NS, PRE_NS,
                                                        RED_NS)
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    from lua_mapreduce_tpu_torch.trace.span import install_tracer
    root = os.path.join(base, "autotune")
    servers, members, jobs, fleet = [], [], [], []

    class RecordingServer(engine.Server):
        def __init__(self, store, **kw):
            super().__init__(store, **kw)
            servers.append(self)
            recording_jobs(unwrap(self.store), jobs)

        def set_fleet(self, hook, size, max_workers=None):
            def resize(target):
                fleet.append(hook(target))
                return fleet[-1]
            fleet.append(size)
            super().set_fleet(resize, size, max_workers)

    class RecordingWorker(engine.Worker):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            members.append(self)

    argv = [os.path.join(root, "coord"), DIGITS, DIGITS, DIGITS, DIGITS,
            "--finalfn", DIGITS, "--storage", f"shared:{root}/spill",
            "--init-arg", f"model_store=shared:{root}/model",
            # --init-arg carries strings: the int args parse back, and
            # sizes (a list) is left at the task's default
            *[a for k, v in POOL_ARGS.items() if k != "sizes"
              for a in ("--init-arg", f"{k}={v}")],
            "--inline-workers", "2", "--autotune",
            "--autotune-max-workers", "4", "--batch-k", "8",
            "--poll", str(POOL_POLL_S), "--trace", "--quiet"]
    if tuple(POOL_ARGS["sizes"]) != (256, 128, 10):
        raise AssertionError("(b) passes the digits task's default sizes")
    real = engine.Server, engine.Worker
    engine.Server, engine.Worker = RecordingServer, RecordingWorker
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = execute_server.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        engine.Server, engine.Worker = real
        install_tracer(None)
    server = servers[0]
    got = run_files(root, lambda r: f"shared:{r}/spill")
    if rc or got != want_bytes:
        raise AssertionError(f"(b) rc {rc}, files differ from phase 21's "
                             f"LocalExecutor")
    jobs += [dict(d, ns=ns) for ns in (MAP_NS, PRE_NS, RED_NS)
             for d in unwrap(server.store).jobs(ns)]
    hold_no_repetitions("(b)", jobs)
    decisions = server._controller.decisions if server._controller else []
    col = TraceCollection.from_store(
        unwrap(get_storage_from(f"shared:{root}/spill")))
    spans = col.autotune_decisions()
    flips = {}
    for d in decisions:
        flips.setdefault(d.knob, []).append(d.direction)
    reversals = {k: sum(a != b for a, b in zip(v, v[1:]))
                 for k, v in flips.items()}
    paired = [(e["knob"], e["old"], e["new"]) for e in spans]
    if paired != [(d.knob, d.old, d.new) for d in decisions] \
            or any(v > 1 for v in reversals.values()):
        raise AssertionError(f"(b) decisions {decisions}, spans {spans}, "
                             f"reversals {reversals}")
    bodies = sum(w.bodies.get("map", 0) for w in members)
    n_it = len(server.stats.iterations)
    if n_it != POOL_ITERS:
        raise AssertionError(f"(b) {n_it} iterations")
    hold_launches(ops, "(b)", counts, bodies, n_it)
    its = server.stats.iterations
    walls = [1e3 * i.wall_time for i in its]
    rep = {"argv": argv[1:], "seconds": wall,
           "decisions": [{"knob": d.knob, "metric": d.metric,
                          "observed": d.observed, "threshold": d.threshold,
                          "old": d.old, "new": d.new} for d in decisions],
           "reversals": reversals, "fleet_sizes": fleet,
           "members": len(members), "map_bodies": bodies,
           "ms_per_iteration": sum(walls[1:]) / (len(walls) - 1),
           "batch_k_doc": (unwrap(server.store).get_task() or {}).get(
               "batch_k"), "launches": counts}
    log(f"[sched] (b) execute_server --autotune --inline-workers 2 "
        f"--autotune-max-workers 4 --batch-k 8: {len(decisions)} "
        f"decision(s), each with its autotune.<knob> span: "
        + ("; ".join(f"{d.knob} {d.old:g} -> {d.new:g} ({d.metric} "
                     f"{d.observed:.4g} vs {d.threshold:.4g})"
                     for d in decisions) or "none")
        + f"; reversals {reversals}; fleet sizes seen {fleet}; "
        f"{len(members)} worker(s) started; {len(jobs)} job docs at 0 "
        f"repetitions; files byte-equal; {rep['ms_per_iteration']:.1f} "
        f"ms/iteration after the first, {wall:.2f} s in main; launches "
        f"{counts}")
    return [counts], rep


def _latencies(docs):
    return [d["started_time"] - d["creation_time"] for d in docs
            if d.get("creation_time") and d.get("started_time")]


def _put_sched_task(view, storage):
    from lua_mapreduce_tpu_torch.core.constants import TaskStatus
    from lua_mapreduce_tpu_torch.engine import TaskSpec
    desc = TaskSpec(taskfn=SCHED_MOD, mapfn=SCHED_MOD,
                    partitionfn=SCHED_MOD, reducefn=SCHED_MOD,
                    init_args={"device": "cpu"}, storage=storage).describe()
    view.put_task({"_id": "unique", "status": TaskStatus.MAP.value,
                   "iteration": 1, "spec": desc, "batch_k": 1})


def _fair_pool(store, tenants):
    import threading

    from lua_mapreduce_tpu_torch.sched import FairScheduler, FairWorker
    sched = FairScheduler(tenants)
    pool = [FairWorker(store, tenants, scheduler=sched, name=f"fair{i}",
                       max_iter=100_000, max_sleep=POOL_MAX_SLEEP_S)
            for i in range(FAIR_MEMBERS)]
    threads = [threading.Thread(target=fw.execute, daemon=True)
               for fw in pool]
    for t in threads:
        t.start()
    return pool, threads


def _finish_flood(store, views, names, n_jobs, threads):
    """Wait for ``n_jobs`` WRITTEN map jobs over ``names``' views, flip
    their tasks to FINISHED and let the pool leave."""
    from lua_mapreduce_tpu_torch.core.constants import (MAP_NS, Status,
                                                        TaskStatus)
    from lua_mapreduce_tpu_torch.sched import notify
    deadline = time.time() + 300
    while sum(views[n].counts(MAP_NS)[Status.WRITTEN]
              for n in names) < n_jobs:
        if time.time() > deadline:
            raise AssertionError("(c) the flood never drained")
        time.sleep(0.01)
    for n in names:
        views[n].update_task({"status": TaskStatus.FINISHED.value})
    notify(store, "jobs")
    for t in threads:
        t.join(timeout=60)
    if any(t.is_alive() for t in threads):
        raise AssertionError("(c) a FairWorker never left")


def sched_tenancy(torch, ops, base, want_bytes):
    """(c): the digits tenant beside a 150-job flood tenant, fair share;
    then a one-tenant FIFO leg of the flood and 8 barrier jobs."""
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.coord.jobstore import make_job
    from lua_mapreduce_tpu_torch.core.constants import MAP_NS, TaskStatus
    from lua_mapreduce_tpu_torch.engine import Server
    from lua_mapreduce_tpu_torch.sched import Tenant, TenantView, tenant_ns
    root = os.path.join(base, "tenancy")
    store = FileJobStore(os.path.join(root, "coord"))
    tenants = [Tenant("train"), Tenant("flood")]
    views = {t.name: TenantView(store, t) for t in tenants}
    seen = []
    recording_jobs(store, seen)
    _put_sched_task(views["flood"], f"shared:{root}/flood")
    views["flood"].insert_jobs(MAP_NS, [make_job(f"f{i}", i)
                                        for i in range(FLOOD_JOBS)])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pool, threads = _fair_pool(store, tenants)
    try:
        server = Server(views["train"], poll_interval=POOL_POLL_S
                        ).configure(digits_pool_spec(
                            os.path.join(root, "train")))
        stats = server.loop()
        _finish_flood(store, views, ["flood"], FLOOD_JOBS, threads)
    except BaseException:
        for n in ("train", "flood"):
            views[n].update_task({"status": TaskStatus.FINISHED.value})
        raise
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    got = run_files(os.path.join(root, "train"), lambda r: f"shared:{r}/spill")
    if got != want_bytes or views["train"].get_task()["status"] != \
            TaskStatus.FINISHED.value:
        raise AssertionError("(c) the train tenant's files differ from "
                             "phase 21's LocalExecutor, or its task did "
                             "not finish")
    bodies = sum(fw._workers["train"].bodies.get("map", 0) for fw in pool)
    n_it = len(stats.iterations)
    if n_it != POOL_ITERS:
        raise AssertionError(f"(c) {n_it} iterations")
    hold_launches(ops, "(c)", counts, bodies, n_it)
    docs = seen + [dict(d, ns=ns) for ns in (tenant_ns("train", MAP_NS),
                                             tenant_ns("flood", MAP_NS))
                   for d in store.jobs(ns)]
    train_map = _latencies(d for d in docs
                           if d["ns"] == tenant_ns("train", MAP_NS))
    flood = _latencies(d for d in docs
                       if d["ns"] == tenant_ns("flood", MAP_NS))
    hold_no_repetitions("(c)", docs)

    # the FIFO leg: one tenant, the flood then 8 barrier jobs behind it
    fstore = FileJobStore(os.path.join(root, "fifo-coord"))
    fifo = [Tenant("fifo")]
    fviews = {"fifo": TenantView(fstore, fifo[0])}
    _put_sched_task(fviews["fifo"], f"shared:{root}/fifo")
    fviews["fifo"].insert_jobs(MAP_NS, [make_job(f"f{i}", i)
                                        for i in range(FLOOD_JOBS)]
                               + [make_job(f"b{i}", i)
                                  for i in range(FIFO_BARRIER_JOBS)])
    t1 = time.perf_counter()
    _, fthreads = _fair_pool(fstore, fifo)
    _finish_flood(fstore, fviews, ["fifo"], FLOOD_JOBS + FIFO_BARRIER_JOBS,
                  fthreads)
    fifo_s = time.perf_counter() - t1
    fdocs = fviews["fifo"].jobs(MAP_NS)
    fifo_barrier = _latencies(d for d in fdocs if d["_id"] >= FLOOD_JOBS)
    fifo_flood = _latencies(d for d in fdocs if d["_id"] < FLOOD_JOBS)
    rep = {"flood_jobs": FLOOD_JOBS, "members": FAIR_MEMBERS,
           "seconds": wall, "map_bodies": bodies,
           "dispatch_s_p50_p99": {
               "fair_train_map": p50_p99(train_map),
               "fair_flood": p50_p99(flood),
               "fifo_barrier": p50_p99(fifo_barrier),
               "fifo_flood": p50_p99(fifo_flood)},
           "fifo_seconds": fifo_s, "launches": counts}
    d = rep["dispatch_s_p50_p99"]
    fmt = lambda v: f"{1e3 * v[0]:.1f}/{1e3 * v[1]:.1f} ms"   # noqa: E731
    log(f"[sched] (c) one FileJobStore, tenants train (digits, a stock "
        f"Server over a TenantView) and flood ({FLOOD_JOBS} one-record "
        f"map jobs), {FAIR_MEMBERS} FairWorker threads on one "
        f"FairScheduler: train's files byte-equal to phase 21's "
        f"LocalExecutor, every flood job WRITTEN, {wall:.2f} s; dispatch "
        f"p50/p99 train maps {fmt(d['fair_train_map'])} "
        f"({len(train_map)} jobs), flood {fmt(d['fair_flood'])}; FIFO leg "
        f"(one tenant, {FIFO_BARRIER_JOBS} barrier jobs behind the flood, "
        f"{fifo_s:.2f} s): barrier {fmt(d['fifo_barrier'])}, flood "
        f"{fmt(d['fifo_flood'])} (not gated); launches {counts}")
    return [counts], rep


def sched_notify(torch, ops, base, want_bytes, workers):
    """(d): phase 21's pool traced with notify on and off."""
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    out, runs = {}, []
    spill = lambda r: f"shared:{r}/spill"    # noqa: E731
    for label, env in (("on", {}), ("off", {"LMR_SCHED_NOTIFY": "0"})):
        prev = os.environ.get("LMR_SCHED_NOTIFY")
        os.environ.update(env)
        try:
            run = run_recovery_pool(torch, ops, base, workers[label],
                                    digits_pool_spec, {})
        finally:
            if prev is None:
                os.environ.pop("LMR_SCHED_NOTIFY", None)
            else:
                os.environ["LMR_SCHED_NOTIFY"] = prev
        bodies, wc = hold_recovery_run(ops, f"(d) notify {label}", run,
                                       want_bytes, spill)
        col = TraceCollection.from_store(
            unwrap(get_storage_from(spill(run["root"]))))
        disp = col.dispatch_stats() or {}
        # iteration 1's claims wait for the workers' boot; the rest are
        # the steady state the wakeups serve
        steady = p50_p99([1e3 * (sp["t1"] - sp["t0"]) for sp in col.spans
                          if sp["name"] == "dispatch"
                          and sp.get("it", 0) >= 2])
        walls = [1e3 * i.wall_time for i in run["stats"].iterations]
        out[label] = {
            "ms_per_iteration": sum(walls[1:]) / (len(walls) - 1),
            "first_iteration_ms": walls[0], "map_bodies": bodies,
            "dispatch": {k: disp.get(k) for k in ("count", "p50_ms",
                                                  "p99_ms")},
            "dispatch_after_first_p50_p99_ms": steady,
            "files": run_files(run["root"], spill)}
        runs += [wc, run["server_counts"]]
    if out["on"].pop("files") != out["off"].pop("files"):
        raise AssertionError("(d) notify on and off differ")
    on, off = out["on"], out["off"]
    log(f"[sched] (d) phase 21's pool traced, notify on vs "
        f"LMR_SCHED_NOTIFY=0: files byte-equal (and to phase 21's "
        f"LocalExecutor); {on['ms_per_iteration']:.1f} vs "
        f"{off['ms_per_iteration']:.1f} ms/iteration after the first; "
        f"insert->claim dispatch p50/p99 {on['dispatch']['p50_ms']:.2f}/"
        f"{on['dispatch']['p99_ms']:.2f} vs {off['dispatch']['p50_ms']:.2f}/"
        f"{off['dispatch']['p99_ms']:.2f} ms over "
        f"{on['dispatch']['count']}/{off['dispatch']['count']} claims; "
        f"after iteration 1 {on['dispatch_after_first_p50_p99_ms'][0]:.2f}/"
        f"{on['dispatch_after_first_p50_p99_ms'][1]:.2f} vs "
        f"{off['dispatch_after_first_p50_p99_ms'][0]:.2f}/"
        f"{off['dispatch_after_first_p50_p99_ms'][1]:.2f} ms")
    return runs, out


def phase_sched(torch, ops):
    """The sched plane on the card (module docstring, phase 27). Every
    part's worker processes start together first, so their boots
    overlap."""
    import shutil
    base = os.path.join(REPO, "build", "smoke-sched")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    want_bytes = task_bytes(os.path.join(REPO, "build", "smoke-pool",
                                         "local"))
    ha = spawn_recovery_workers(base, "ha")
    notify = {"on": spawn_recovery_workers(base, "notify-on"),
              "off": spawn_recovery_workers(
                  base, "notify-off", env_extra={"LMR_SCHED_NOTIFY": "0"})}
    rep, runs = {}, []
    try:
        for key, fn, args in (
                ("ha", sched_ha, (ha,)),
                ("autotune", sched_autotune, ()),
                ("tenancy", sched_tenancy, ()),
                ("notify", sched_notify, (notify,))):
            t0 = time.perf_counter()
            counts, rep[key] = fn(torch, ops, base, want_bytes, *args)
            rep[key]["part_s"] = time.perf_counter() - t0
            runs += counts
    finally:
        for w in (ha, notify["on"], notify["off"]):
            stop_workers(w["procs"], 0)
    return runs, rep


LOCKCHECK = "lua_mapreduce_tpu_torch/utils/lockcheck.py"
LAUNCH_LOCK = "ops/__init__.py::_launch_lock"


def lockcheck_child(args):
    """Phase 28's run, called as ``FUNC`` by the sanitizer's launcher
    (``python LOCKCHECK REPORT chip_smoke:lockcheck_child ROOT DEVICE``)
    in a child process, the sanitizer installed before any of the port's
    locks exist: phase 21's digits task through ``cli.execute_server.
    main`` on a ``MemJobStore`` with two inline workers, ``shared:``
    spill, the pipelined shuffle, speculation, the HA leader lease and
    notify wakeups, all at once. Returns the launches, the map bodies,
    the iterations and the threads started, by target."""
    import threading

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lua_mapreduce_tpu_torch import engine, ops
    from lua_mapreduce_tpu_torch.cli import execute_server
    root, device = args
    servers, members, started = [], [], {}

    class RecordingServer(engine.Server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    class RecordingWorker(engine.Worker):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            members.append(self)

    real_start = threading.Thread.start

    def start(thread):
        name = getattr(thread._target, "__qualname__", None) or str(
            thread._target)
        started[name] = started.get(name, 0) + 1
        return real_start(thread)

    argv = ["mem", DIGITS, DIGITS, DIGITS, DIGITS, "--finalfn", DIGITS,
            "--storage", f"shared:{root}/spill",
            "--init-arg", f"model_store=shared:{root}/model",
            *[a for k, v in POOL_ARGS.items() if k != "sizes"
              for a in ("--init-arg", f"{k}={v}")],
            "--init-arg", f"device={device}",
            "--inline-workers", "2", "--pipeline",
            "--speculation-factor", "3", "--ha",
            "--poll", str(POOL_POLL_S), "--quiet"]
    real = engine.Server, engine.Worker
    engine.Server, engine.Worker = RecordingServer, RecordingWorker
    threading.Thread.start = start
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = execute_server.main(argv)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        threading.Thread.start = real_start
        engine.Server, engine.Worker = real
    return {"rc": rc, "launches": counts, "seconds": wall,
            "bodies": sum(w.bodies.get("map", 0) for w in members),
            "iterations": len(servers[0].stats.iterations),
            "threads": started}


def phase_lockcheck(torch, ops):
    """The runtime lock-order sanitizer on the card (module docstring,
    phase 28)."""
    import shutil
    base = os.path.join(REPO, "build", "smoke-lockcheck")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    want_bytes = task_bytes(os.path.join(REPO, "build", "smoke-pool",
                                         "local"))
    path = os.path.join(base, "lockcheck.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, LOCKCHECK), path,
         "chip_smoke:lockcheck_child", base, "cuda"],
        cwd=REPO, env=subprocess_env(), timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"the sanitized run exited {proc.returncode}")
    with open(path) as f:
        rep = json.load(f)
    res, seen, model = rep["result"], rep["report"], rep["model"]
    got = run_files(base, lambda r: f"shared:{r}/spill")
    if res["rc"] or got != want_bytes:
        raise AssertionError(f"rc {res['rc']}; files differ from phase "
                             f"21's LocalExecutor")
    if res["iterations"] != POOL_ITERS:
        raise AssertionError(f"{res['iterations']} iterations")
    hold_launches(ops, "the sanitized run", res["launches"], res["bodies"],
                  res["iterations"])
    if rep["violations"] or model["cyclic"] or not seen["acquisitions"]:
        raise AssertionError(f"violations {rep['violations']}, cyclic "
                             f"{model['cyclic']}, {seen['acquisitions']} "
                             f"acquisitions")
    # every launch takes the counter's lock once: the card's launch path
    # ran under the sanitizer
    launch_site = [s for s, lbl in model["labels"].items()
                   if lbl == LAUNCH_LOCK]
    taken = sum(seen["site_acquisitions"].get(s, 0) for s in launch_site)
    n_launches = sum(res["launches"].values())
    if not launch_site or taken < n_launches:
        raise AssertionError(f"{LAUNCH_LOCK} at {launch_site} taken "
                             f"{taken} times for {n_launches} launches")
    ctl = rep["control"]
    if not ctl or not any(f"order {ctl['edge'][0]} -> {ctl['edge'][1]} "
                          in v for v in ctl["violations"]):
        raise AssertionError(f"negative control: {ctl}")
    out = {"seconds": seconds, "run_s": rep["run_s"],
           "model_s": rep["model_s"], "main_s": res["seconds"],
           "acquisitions": seen["acquisitions"],
           "sites": seen["sites"], "edges": seen["edges"],
           "violations": rep["violations"],
           "site_acquisitions": seen["site_acquisitions"],
           "max_hold_s": seen["max_hold_s"],
           "static": {"sites": model["sites"], "edges": model["edges"]},
           "control": ctl, "threads": res["threads"],
           "map_bodies": res["bodies"], "launches": res["launches"]}
    log(f"[lockcheck] acquisitions {seen['acquisitions']}, sites "
        f"{len(seen['sites'])}, edges {len(seen['edges'])} "
        f"({'; '.join(' -> '.join(e) for e in seen['edges'])}), "
        f"violations {len(rep['violations'])}; static model: sites "
        f"{model['sites']}, edges {model['edges']}; {LAUNCH_LOCK} taken "
        f"{taken} times for {n_launches} launches; control: without "
        f"{' -> '.join(ctl['edge'])} verify reports it; threads started "
        f"{res['threads']}; files byte-equal; {seconds:.1f} s (run "
        f"{rep['run_s']:.1f} s, model {rep['model_s']:.1f} s)")
    return [res["launches"]], out


# ------------------------------------------------------------ phase 29

def table_peaks(torch):
    """The card's bf16 and HBM peaks from ``utils/roofline.py``; fails
    unless both come from its table for this card (not an environment
    override, not the probe)."""
    from lua_mapreduce_tpu_torch.utils import roofline
    name = torch.cuda.get_device_name(0)
    flops, hbm = roofline.peak_flops_per_s(), roofline.peak_hbm_bytes_per_s()
    if (name not in roofline.PEAK_BF16_FLOPS
            or flops != roofline.PEAK_BF16_FLOPS[name]
            or hbm is None or hbm != roofline.PEAK_HBM_BYTES.get(name)):
        raise AssertionError(f"{name}: peaks {flops} FLOP/s, {hbm} B/s do "
                             f"not come from the roofline table")
    return flops, hbm


@functools.lru_cache(maxsize=None)
def peaks():
    """The card's dense bf16 FLOP/s and HBM B/s, for the bound of each
    kernel call and every MFU: ``utils/roofline.py``'s table for the
    card's name (NVIDIA data-sheet values). Read where first needed, so
    that a phase run on its own (``chip_ab.py``) has them too."""
    import torch
    return table_peaks(torch)


def phase_roofline(torch, ops, gen, wide, conv, lm):
    """The roofline module on the card (module docstring, phase 29)."""
    from lua_mapreduce_tpu_torch.utils import roofline
    card = gpu_line()
    flops, hbm = table_peaks(torch)
    probe = roofline._measured_peak("cuda")
    if probe > PROBE_SLACK * flops:
        raise AssertionError(f"the probe's {probe:.4e} FLOP/s passes "
                             f"{PROBE_SLACK} x the table's {flops:.4e}")
    n = ROOFLINE_N
    a = torch.randn((n, n), device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn((n, n), device="cuda", generator=gen).to(torch.bfloat16)
    ops.reset_launch_counts()

    def run():
        ops.matmul(a, b)
        torch.cuda.synchronize()

    run()                           # warm
    seconds = roofline.best_time(run)
    counts = ops.launch_counts()
    want = {**dict.fromkeys(ops.KERNELS, 0), "matmul_bf16": 4}
    if counts != want:
        raise AssertionError(f"roofline launches {counts}, expected {want}")
    b1_mfu = roofline.mfu(2 * n ** 3, seconds)
    # the MFU lines of phases 5, 8 and 10, each roofline.mfu of that
    # phase's own FLOPs and seconds
    lines = ([("wide", wide)] + [(f"conv {m}", r) for m, r in conv.items()]
             + [(f"lm train {t}", r) for t, r in lm.items()])
    out = {"card": card, "peak_bf16_flops": flops, "peak_hbm_bytes": hbm,
           "probe_flops": probe, "probe_share": probe / flops,
           "b1_bf16_n": n, "b1_bf16_ms": seconds * 1e3,
           "b1_bf16_mfu": b1_mfu,
           "mfu": {what: r["mfu"] for what, r in lines}}
    log(f"[roofline] {card}: table peaks {flops / 1e12:g} TFLOP/s bf16 "
        f"dense, {hbm / 1e12:g} TB/s HBM; the probe (torch.matmul, 4096^3 "
        f"bf16, best of 3) {probe / 1e12:.1f} TFLOP/s, "
        f"{100 * probe / flops:.2f}% of the table's peak")
    shares = ", ".join(f"{w} {100 * m:.3f}%" for w, m in out["mfu"].items())
    log(f"[roofline] B1 bf16 {n}^3 (ops.matmul, best of 3 on the host "
        f"clock): {seconds * 1e3:.4f} ms, MFU {100 * b1_mfu:.2f}%; the MFU "
        f"lines of phases 5, 8 and 10: {shares}")
    return [counts], out


def glob_files(root, pattern):
    import glob
    return sorted(glob.glob(os.path.join(root, pattern)))


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {out.stderr.strip()}"


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from lua_mapreduce_tpu_torch import ops
    from lua_mapreduce_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks()               # an unknown card fails the run here
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    rep = _build.build_all()
    log(f"[build] compiled {rep['built']} in {rep['seconds']:.2f} s")
    for name, out in rep["ptxas"].items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    phase_s = {}

    def clock(name, fn, *args):
        """Run one phase and print its seconds."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] {name}: {phase_s[name]:.1f} s")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = (phase_kernels(torch, ops, gen) + phase_serving_kernels(torch, gen)
            + phase_flash_bwd_kernels(torch, gen)
            + phase_conv_kernels(torch, gen))
    for r in rows:
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        extra = ""
        if r.get("norm_err") is not None:
            extra = f", normwise {r['norm_err']:.3e}"
        if r.get("control_norm_err") is not None:
            extra += (f" (scale 5% off: {r['control_norm_err']:.3e}, "
                      f"refused)")
        if r.get("splits") is not None:
            extra += f", splits {r['splits']}"
        if r.get("cold_ms") is not None:
            extra += (f", {r['cols']}-column strips, {r['ctas']} CTAs "
                      f"(clusters of 1/2/4/8 on {r['cluster_sms']} SMs), two "
                      f"calls bit-equal; cold (weights over "
                      f"{r['cold_copies'][0]} copies) kernel "
                      f"{r['cold_ms']:.4f} ms, library "
                      f"{r['cold_library_ms']:.4f} ms")
        if r.get("plan_sweep_ms"):
            extra += "; every plan " + ", ".join(
                f"{k} {v * 1e3:.2f} us" for k, v in r["plan_sweep_ms"].items())
        if r.get("path") is not None:
            extra += f", {r['path']} kernel"
        if r.get("copies") is not None:
            extra += f" (A/B copies {r['copies']})"
        if r.get("branch") is not None:
            extra += f", {r['branch']} branch, two calls bit-equal"
        if r.get("n_split") is not None:
            extra += (f", n_split {r['n_split']}, two calls bit-equal")
        if r.get("plan") is not None and r["kernel"] == "matmul_bf16":
            p_ = r["plan"]
            how = {"none": f"epilogue {p_.get('epilogue')}",
                   "cluster": f"summed in a cluster of {p_.get('cluster')}",
                   "slab": "summed through a slab"}[p_.get("reduce")]
            extra += (f"; plan {p_['kernel']} {p_.get('tile')} split "
                      f"{p_['splits']} ({how}), two calls bit-equal")
        if r.get("cudnn_conv_ms") is not None:
            extra += f"; the whole conv through cuDNN {r['cudnn_conv_ms']:.4f} ms"
        if r.get("library_note"):
            extra += f"; library {r['library_note']}"
        log(f"[kernel] {r['case']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']:.3e}{extra}")
    conv_totals = {}
    for cfg in ("lenet", "resnet"):
        mine = [r for r in rows if r.get("conv_config") == cfg]
        tot = {key: sum(r[key] * r["per_step"] for r in mine)
               for key in ("ms", "library_ms")}
        conv_totals[cfg] = tot
        log(f"[kernel] {cfg} conv step's products (x per-step counts): "
            f"kernel {tot['ms']:.4f} ms")
        log(f"[kernel] {cfg} conv step's products (x per-step counts): "
            f"torch.matmul {tot['library_ms']:.4f} ms "
            f"({tot['ms'] / tot['library_ms']:.2f}x)")
    grads = clock("phase_grads", phase_grads, torch, ops, gen)
    digits_counts, val, _ = clock("phase_digits", phase_digits, torch, ops)
    wide_counts, wide = clock("phase_wide", phase_wide, torch, ops, gen)
    serving = clock("phase_serving", phase_serving, torch, ops)
    check = clock("phase_serving_check", phase_serving_check, torch, ops)
    conv = clock("phase_conv", phase_conv, torch, ops, gen)
    conv_check = clock("phase_conv_check", phase_conv_check, torch, ops)
    lm = clock("phase_lm_train", phase_lm_train, torch, ops)
    lm_check = clock("phase_lm_check", phase_lm_check, torch, ops)
    train_lm = clock("phase_train_lm", phase_train_lm, torch, ops)
    digits_e2e = clock("phase_digits_e2e", phase_digits_e2e, torch)
    resume = clock("phase_resume", phase_resume, torch)
    kmeans_counts, kmeans = clock("phase_kmeans", phase_kmeans, torch, ops)
    als_counts, als = clock("phase_als", phase_als, torch, ops)
    dp_counts, dp = clock("phase_dp_train", phase_dp_train, torch, ops, gen)
    executor_counts, executor = clock("phase_executor", phase_executor,
                                      torch, ops)
    ingraph_counts, ingraph, sgd_params = clock("phase_ingraph", phase_ingraph,
                                                torch, ops)
    hybrid_counts, hybrid_cache = clock(
        "phase_hybrid_cache", phase_hybrid_cache, torch, ops)
    pool_counts, pool = clock("phase_pool", phase_pool, torch, ops, sgd_params)
    mesh = clock("lm_mesh", lm_mesh, torch)
    moe_train = clock("phase_moe_train", phase_moe_train, torch, ops, mesh)
    moe_serve = clock("phase_moe_serve", phase_moe_serve, torch, ops)
    moe_check = clock("phase_moe_check", phase_moe_check, torch, ops, mesh)
    meshes = clock("tp_pp_meshes", tp_pp_meshes, torch)
    tp_pp = clock("phase_tp_pp_train", phase_tp_pp_train,
                  torch, ops, meshes, mesh, lm)
    tp_pp_check = clock("phase_tp_pp_check", phase_tp_pp_check,
                        torch, ops, meshes, mesh)
    dataplane_counts, dataplane = clock("phase_dataplane", phase_dataplane,
                                        torch, ops, pool)
    recovery_counts, recovery = clock("phase_recovery", phase_recovery,
                                      torch, ops)
    native_counts, native = clock("phase_native", phase_native,
                                  torch, ops, pool, dataplane)
    sched_counts, sched = clock("phase_sched", phase_sched, torch, ops)
    lockcheck_counts, lockcheck = clock("phase_lockcheck", phase_lockcheck,
                                        torch, ops)
    roofline_counts, roofline_rep = clock("phase_roofline", phase_roofline,
                                          torch, ops, gen, wide, conv, lm)
    if phase_s["phase_roofline"] >= ROOFLINE_LIMIT_S:
        raise AssertionError(f"phase 29 took {phase_s['phase_roofline']:.1f}"
                             f" s, past its {ROOFLINE_LIMIT_S} s")
    runs = ([digits_counts, wide_counts]
            + [serving[t]["launches"] for t in serving]
            + [conv[m]["launches"] for m in conv]
            + [lm[t]["launches"] for t in lm]
            + [kmeans_counts, als_counts, executor_counts] + dp_counts
            + ingraph_counts + hybrid_counts + pool_counts
            + [moe_train["launches"]]
            + [moe_serve[t]["launches"] for t in moe_serve]
            + [tp_pp[t]["launches"] for t in ("2d_mesh", "3d", "pp")]
            + dataplane_counts + recovery_counts + native_counts
            + sched_counts + lockcheck_counts + roofline_counts)
    launches = {k: sum(c[k] for c in runs) for k in ops.KERNELS}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    kernels = []
    for name in ops.KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        top = max(mine, key=lambda r: r["bound_ms"])
        src, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"]})

    gpu = gpu_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    report = {"gpu": gpu, "device": device, "build": {
        "built": rep["built"], "seconds": rep["seconds"],
        "ptxas": rep["ptxas"]},
        "cases": rows, "conv_product_totals": conv_totals,
        "grads_max_abs_err": grads,
        "digits": {"val_loss": val, "launches": digits_counts},
        "wide": {**wide, "launches": wide_counts}, "serving": serving,
        "serving_check": check, "conv": conv, "conv_check": conv_check,
        "lm_train": lm, "lm_check": lm_check, "train_lm": train_lm,
        "digits_e2e": digits_e2e, "resume": resume, "kmeans": kmeans,
        "als": als, "dp_train": dp, "executor": executor,
        "ingraph": ingraph, "hybrid_cache": hybrid_cache, "pool": pool,
        "moe_train": moe_train, "moe_serving": moe_serve,
        "moe_check": moe_check, "tp_pp_train": tp_pp,
        "tp_pp_check": tp_pp_check, "dataplane": dataplane,
        "recovery": recovery, "native": native, "sched": sched,
        "lockcheck": lockcheck, "roofline": roofline_rep,
        "kernels": kernels, "phase_seconds": phase_s,
        "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['seconds']:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
