#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, each failing hard:
  1. build the three CUDA kernel libraries (spectral, with its four
     kernels; RMSNorm; flash attention) from the repository's sources, all
     three at once, and beside them compile the sources redesigned for the
     H100 (``REPORTED_SOURCES``) once more with ``-Xptxas -v`` to print each
     kernel's registers, shared memory and spills;
  2. hold the fused spectral kernel against its plain PyTorch version
     (``spectral_apply_fused_ref`` + ``pad_kept_ref``) over the trunc
     patterns, t tails, ``add`` and the full-width serving block shape,
     and time both with CUDA events; then the weight-cotangent kernel
     against ``spectral_fused_dw_ref`` over the trunc patterns, t tails
     and the layouts that rfftn and the irfftn backward hand it, and the
     fused op's autograd backward (dx on the fused kernel, dW on the
     cotangent kernel) against plain autograd; both backward kernels are
     timed at the training block shape, the dW kernel on the FFT layouts
     and on contiguous operands (both held to the gate, two launches held
     bitwise equal) beside ``zero_()`` of a w-sized tensor, its store floor;
 2b. the flattened-K op ``spectral_apply``: its mix kernel (forward and
     dx on conj(W^T)) and weight-cotangent kernel against
     ``spectral_apply_ref`` / ``spectral_dw_ref`` over 1-4 mode dims,
     ragged K (K at the mix kernel's tile and 16-byte pair edges, odd K on
     its 8-byte path), ci != co, co past its 40-channel chunk, b = 1-6,
     permuted batch/channel strides and the P = 4 shard's mode shape, the
     mix kernel's forward and dx bitwise the same over two runs; its
     autograd backward against plain autograd; the mix kernel against the
     fused kernel on pre-truncated modes; one forward + backward through
     the op at the Sleipner FNO's full kept-mode width (ci = co = 40,
     modes (48,32,16,10), b = 2) with exact launch counts; both kernels
     timed there at b = 2 and b = 1 and at the 1-D model-parallel shard
     (48,8,16,10), against their bound, the plain version (one
     ``torch.einsum``, also the library call) and ``torch.bmm`` on the
     K-leading layout; the mix kernel between CUDA events around one call,
     as its first version's recorded time (``FLAT_FIRST_MS``, printed
     beside) was taken, and a call back to back (CUDA events around 20
     calls);
  3. serve the Sleipner FNO (width 40, modes (24,16,8,10), 4 blocks) on
     grid (128,64,32,88) through ``FNORunner`` and the ``Scheduler``,
     checking every output against the plain unfused forward;
  4. the same size as an ensemble (2 input channels, 1 static geomodel)
     through the deep-split cache: hit-rate > 0, cold == warm bitwise,
     verified likewise;
  5. the serving CLI on a small checkpoint written by the port, with
     ``--verify``, as a subprocess; then on the same checkpoint the fleet
     CLI (``--replicas 2 --policy affinity --cache-store DIR --max-steps
     200 --ensemble --verify``);
 5b. fleet: two full-width replicas (4 blocks, deep level) behind the
     port's ``Gateway`` on grid (64,32,32,88), one fixed bucket, affinity
     routing and a ``FileCacheStore``: 8 scenarios over two geomodels and
     2 duplicates, served first by one plain ``FNORunner`` (which computes
     both geomodels and publishes them to the store), then by the replicas
     (their caches empty: both geomodels from the store), each replica's
     outputs bitwise the single runner's, the geomodels pinned to different
     replicas, the fleet's hit-rate within 0.05 of the single runner's;
     then the same wave after the replica of geomodel 0 raises: rerouted
     to the survivor, which hits the store, bitwise the first wave; then
     ``serve_open_loop``'s makespan with per-replica executors and one
     shared executor; verified against the unfused plain forward; the
     cold prefix, the store's put and get and each tick timed;
  6. train the same model at full width on grid (64,32,32,88): every
     leaf's gradient through the fused path against the unfused forward's,
     then 4 steps of ``make_train_step`` (batch 2 as 2 micro-batches,
     remat on) fed by ``ShardedDatasetLoader``;
  7. the training CLI on the card with an injected fault (restored from
     its checkpoint), then the serving CLI with ``--verify`` on the
     checkpoint it wrote;
 7a. data: the two-phase (IMPES + CG) and Navier-Stokes simulators on the
     card against themselves on the CPU (32x16x8 x 8 frames, n = 32 x 8),
     each timed at full size for 2 frames (two-phase at ``ONE_CARD_GRID``
     and the paper grid, with its CG iterations a solve and the ratio to
     the served tick's time a scenario; Navier-Stokes at 128^3); the
     fno-ns3d FNO at full width on grid 64^3 x 64 (block 0's fused kernel
     against its plain version, the forward against the unfused one,
     exact launches); then ``train --online`` on the card (2 spawned
     datagen workers, 4 samples, 4 steps), every sample complete,
     ``datagen --resume`` simulating nothing with the stats bit for bit,
     and ``serve_pde --verify --reference`` on its checkpoint;
 7b. dist: the domain-decomposed FNO (``make_dist_forward``) on 4 gloo
     ranks sharing the card (NCCL refuses two ranks on one device), 1-D
     (paper Alg. 2, x over P = 4) and 2-D pencils (x and y over 2 x 2),
     started by ``launch_ranks`` after this process has built the kernels
     (the ranks only load them). First the fused kernel (forward, dx, and
     forward with the deep split's ``add``) and the dW kernel at the 1-D
     and 2-D shard shapes of the served and training grids, in this
     process alone, against their plain versions and timed beside their
     bounds; then ``FNORunner`` over the ranks (rank 0 the controller) at
     full width on the served grid (128,64,32,88): one paper tick of
     bucket 2 on each layout, rank 0's gathered outputs against the serial
     fused forward, with each tick's split (scatter, forward, gather), each
     rank's peak memory and one block's split (FFTs, all-to-alls, the fused
     kernel); then a deep-split ensemble over the pencils on the training
     grid (2 scenarios sharing one geomodel, 2 rollout steps, a cold and a
     warm pass): cold == warm bitwise, the cache hit, the outputs against
     the unfused serial oracle once the ranks exit; then the ranked fleet:
     two replicas over 1 x 4 at the training grid, linked to share the one
     start of the ranks, behind the gateway (two geomodels, prelift level,
     one tick each), rank 0's outputs against the serial fused forward at
     the dist gate; then on the training grid, batch 1,
     the eager, Grady-31 (1-D) and ``comm_chunks=2`` schedules against the
     serial forward, and one paper forward + backward of each layout whose
     every leaf's gradient is held against the serial gradient on the card;
     then in the same launch the GPipe pipeline (``core/pipeline.py``) at
     full width on the training grid, 4 stages of one block, batch 2 as 2
     micro-batches: rank 0's output against the serial forward, every
     stage's gradients against the serial ones (the gate refusing zeros, 4
     times the gradient, ci/co swapped and the next stage's block), each
     stage's tick, send and bubble times beside ``bubble_efficiency(4,
     2)``; and top-k compression with error feedback over the 4 ranks on a
     64 MiB float32 and a 64 MiB complex64 leaf a rank (ratio 1 equal to
     the dense mean with a zero residual, ratio 0.01 conserving it), with
     the wire bytes of the 3.15 GB ``w_spec`` shard;
 7c. dist_train: the distributed train step (ZeRO-1, per-rank shard
     reads) on 4 ranks at full width on the training grid, (1 data x 2x2
     pencils) for 3 steps and (2 data x 2 model) with 2 blocks for 2,
     each against the serial train step on the card: every step's loss and
     grad norm, and every param after the last step on every rank; then
     the training CLI on 4 ranks (``--devices 4 --model-shards 2 2``)
     through an injected fault, and the serving CLI with ``--verify`` on
     its checkpoint, on one card and on 4 ranks (``--devices 4
     --model-shards 2 2``);
  8. hold the RMSNorm and flash-attention kernels against their plain
     versions (``rmsnorm_ref``, ``flash_attention_ref``) over bf16 and f32,
     ragged rows and tails, MHA/GQA/MQA, sq < sk, non-causal, head dims
     16-256 (24 padded to the 32 instance) and the serving path's shapes in
     bf16 and f32 (gemma-7b, chatglm3-6b and minitron-8b prefills,
     deepseek-v2-lite's MLA prefill at head dim 192, recurrentgemma-2b's
     MQA prefill of 10 query heads over 1 kv head at head dim 256,
     whisper-tiny's non-causal attention at head dim 64 over its 1500
     frames (the encoder, at batch 4 and 1; the cross-attention of a
     prefill, of a decode step's one query row and of the loss) and the
     loss's causal self-attention, prefill and decode norms at gemma's d
     3072, deepseek-v2-lite's d_model 2048 (also mamba2-370m's gated
     norm), its MLA latent's 512, mamba2-370m's d_model 1024 and
     recurrentgemma-2b's 2560; RMSNorm also at a d of no whole 16-byte
     vectors and on x offset by one element, its scalar path, each output
     bitwise the same over two runs), with bf16 held to one rounding of
     the output, and time each against its bound, its plain version and
     one PyTorch call (``F.rms_norm``, ``F.scaled_dot_product_attention``,
     masked only when causal) as a yardstick, RMSNorm beside its launch
     plan and its first version's recorded time (``RMSNORM_FIRST_US``), and
     an empty kernel between two CUDA events beside rmsnorm's decode
     reading, the floor of any launch;
  9. serve gemma-7b at full width (28 layers, d_model 3072, random
     weights) through ``Engine``: 8 requests of 200-1000 prompt tokens on 4
     slots, 16 tokens each; then, for 2 of the prompts, the prefill's
     last-token logits and the first decode step's logits through the
     kernels against the same through the plain versions;
 9b. the same for deepseek-v2-lite-16b at full width (27 layers, d_model
     2048, MLA 512/128/64/128, 64 routed experts top-6 + 2 shared, vocab
     102400), its weights drawn and cast one leaf at a time (the peak
     printed), with the prefills' MoE drop share and the decode steps held
     dropless;
 9c. recurrent serving: the same for mamba2-370m (48 SSD layers, d_model
     1024, d_state 128) and recurrentgemma-2b (26 layers of rec, rec, attn:
     RG-LRU width 2560, local MQA attention 10 x 256 over 1 kv head, window
     2048, GeGLU 7680, vocab 256000), max_len 2320; recurrentgemma takes
     two more requests, a 2300-token prompt (the windowed prefill: no flash,
     a rolled ring) and a 2040-token one whose decode crosses the ring's
     wrap at index 2048; besides the 2 prompts' logits, those of the
     windowed prefill and of the decode step at index 2048 (fed the
     engine's tokens) are held against the plain path; mamba2's bf16
     logits at 1.5 times the reference's own kernel-vs-plain gap at its
     48 layers (``MAMBA2_BF16_LOGIT_GATE``), the others' at 3e-2;
 9d. whisper serving: full-width whisper-tiny (4 + 4 layers, d_model
     384, 6 heads of 64, vocab 51865) through its ``whisper_*`` entry
     points, random bf16 weights: a batch of 4 stub frame sequences
     [1500, 384], 4-token prompts, a prefill and 60 greedy decode steps
     (flash exactly 8 + 4 x 60 times, no RMSNorm), the encoder timed;
     the prefill's and the first decode step's logits through the kernels
     against the plain versions in bf16 (3e-2 of max|ref|) and with f32
     activations (1e-4 of max|ref|; the decode step on a copy of the
     kernel run's bf16 caches, and on its own printed), the bf16 greedy
     tokens equal; one teacher-forced ``whisper_loss`` on 448 tokens (12
     flash launches; its scalar printed), and ``decode_train``'s final
     hidden states on those tokens held the same way;
 10. the LM serving CLI on the card, as five subprocesses at once, for
     reduced gemma-7b, deepseek-v2-lite-16b (flash at head dim 24, padded
     to 32), deepseek-moe-16b, mamba2-370m and recurrentgemma-2b;
 11. lm train: gemma-7b at full width with its depth cut to 4 layers
     (2.68 B params, f32 masters): every leaf's gradient through the
     kernels against the plain versions' with f32 activations on one
     micro-batch of 1024 tokens (within 1e-4 of the leaf's max|ref|, no
     leaf zero or missing; a run with the kernels' outputs cut from the
     graph must be refused), then 3 AdamW steps (batch 2 x 1024 as 2
     micro-batches, remat on, bf16 activations: step ms, tokens/s, peak
     memory, the init loss within 1.5 of ln(vocab)); the same gate for
     ``whisper_loss`` on whisper-tiny at full width (batch 4, 1500
     frames, 448 tokens, f32); the two kernels' forward and backward (the
     plain version's gradient) by device time at the training shapes;
     then ``train --mode lm`` for each arch of the LM CLI through a fault
     (its losses against an uninterrupted run of the entry point in this
     process) and reduced gemma-7b on 2 ranks;
 12. dist lm: the distributed LM on 4 gloo ranks sharing the card, at full
     width with the depth cut (chatglm3-6b 2 of 28 layers; deepseek-moe-16b
     its dense layer 0 and 1 MoE layer), batch 2 x 1024, f32: the serial
     loss and gradient on the card through the kernels first (the MoE
     routing each (data, model) shard's tokens with that shard's capacity,
     as the expert-parallel path does), shared with the ranks by CUDA IPC;
     then on (1 x 4) with seq_shard and on (2 x 2) without, each rank's
     shards (``shard_params``) and rows through ``lm_loss`` under the mesh
     policy (tensor-parallel attention with chatglm3-6b's 2 kv heads
     gathered, the all-to-all MoE with the serial run's routes replayed,
     the vocab-parallel loss), its gradients reduced by ``reduce_grads``:
     the loss within the reference's rtol 3e-3, every leaf of every rank at
     rtol 5e-3 with an atol of 1e-3 of the leaf's max|ref| (the gate must
     refuse zeros, the next rank's shard and a run with the kernels' outputs
     cut), exact launches equal on every rank; Ulysses over chatglm3-6b's
     heads at s = 4096 through the flash kernel against serial flash (bf16
     and f32); 3 bf16 AdamW steps on (1 x 4) timed (step ms, the
     collectives' share, peak memory, tokens/s); both kernels by device
     time at the ranks' shard shapes beside bound, plain, SDPA and
     ``F.rms_norm``; then ``train --mode lm --arch deepseek-moe-16b
     --devices 2`` through a fault against one rank. Since slice 21 also
     whisper-tiny at full width and depth (4 + 4 layers, batch 4 x 448,
     1500 frames): the same gates against its serial run on the card (a
     key bias's leaf at its query bias's scale), a run with the
     cross-attention's sum over the group cut (on 2 x 2) and one with the
     LayerNorms' ``copy_to`` cut (on 1 x 4 seq_shard) refused, 2 bf16 AdamW
     steps timed, flash at its shard heads (bf16 and f32) timed;
 13. dist serve lm: LM serving over the 4 ranks (``Engine(policy=)``, the
     decoder families; see ``phase_dist_serve_lm``), and since slice 21
     whisper-tiny at full width (batch 4, 4-token prompts, 16 greedy steps)
     on (1 x 4) seq_shard, (2 x 2) and (4 x 1): f32 weights and caches,
     tokens equal to the serial run's on the card and logits within 1e-5
     of max|ref|, launches exact; bf16 timed on (1 x 4); flash at its
     decode step's cross-attention shard shapes timed. Every dist phase
     prints its collectives' bytes on the wire by kind beside their time;
 14. dryrun: ``launch/dryrun.py --all`` (cells, and how many fit the
     card), then its per-rank parameter and cache bytes held exactly
     against what the ranks of phases dist, dist lm and dist serve lm held
     (whisper-tiny on every layout, the Sleipner FNO's P = 4 shards), each
     rank's ``max_memory_allocated`` beside them.

One forward + backward through ``spectral_apply`` must launch its mix
kernel twice (forward, dx), its weight-cotangent kernel once, and no other
kernel. Each served run must launch the fused kernel exactly once per FNO block
per forward: the fleet on each replica in each wave (after the failover on
the survivor), its single runner, and the fleet CLI as the serving CLI;
each training step, per micro-batch and block, three times (forward, remat
recompute, dx) and the cotangent kernel once; each dist forward, on every
rank, the fused kernel once per block (a served tick is one forward; the
ranked fleet's two ticks, one on each replica, 2 x 4), and the dist
backward 3 times per block and the cotangent kernel once; each dist train
step, on every rank, as a training step on its micro-batches; each
pipeline stage, in a forward + backward, the fused kernel 3 times per
micro-batch (forward, remat recompute, dx) and the cotangent kernel once;
the fno-ns3d forward once per block; the online trainer and its served
checkpoint as the training and serving CLIs. Each LM
prefill must launch flash attention once per attention layer (none past a
sliding window, none for mamba2), and each LM forward (prefill or decode
step) the RMSNorm kernel 2 L + 1 times (3 L + 1 under MLA, with the
latent's norm; an SSM layer's second norm is its mixer's gated norm).
Whisper's prefill launches flash once per encoder layer and once per
decoder layer (the cross-attention; the decoder's self-attention there
is the plain version, as in the reference), a decode step once per
decoder layer, a ``whisper_loss`` 3 times per layer pair; none of them
the RMSNorm kernel (whisper's norms are LayerNorms). A training pass
(forward + backward of ``lm_loss``) launches each layer's kernels twice
(the forward and remat's recompute) and the final norm once
(``train_launches``); the backward, the plain versions' gradient, none.
In phase dist lm every rank launches the same: a gate pass (remat off)
RMSNorm 2 L + 1 times and flash once per attention layer, a timed step
as a training pass, a Ulysses call flash once; whisper on every rank of a
model group as serially (``flash_per_loss``, ``flash_per_prefill`` and
one a decoder layer a decode step).

Prints each phase's seconds, the card's name and power limit, one
``{"kernels": [...]}`` line,
and as the last line ``{"ok": true, "device": {...}}``. Exits non-zero
without a result when there is no CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet; ``repro_torch.common.constants``):
# HBM3 bandwidth, the float32 rate outside the tensor cores, the dense bf16
# tensor-core rate. Bounds are computed against these.
from repro_torch.common.constants import (  # noqa: E402
    HBM_BANDWIDTH as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOP_PER_S,
    PEAK_FLOPS_F32 as FP32_FLOP_PER_S,
)
TOL_REL, TOL_ABS = 1e-4, 1e-6
# LM kernels vs their plain versions, elementwise; both compute in f32 and
# cast once. f32: |d| <= 1e-5 + 1e-5 |ref| (sums in another order). bf16:
# one rounding of the output apart, |d| <= 2^-7 |ref|, plus 1e-3 max|ref|
# for values near zero, whose f32 sums carry the error of the larger terms.
LM_F32_TOL = 1e-5
LM_BF16_REL, LM_BF16_ABS_OF_MAX = 2.0 ** -7, 1e-3
# full-width served logits through the kernels vs through the plain
# versions: 28 layers of bf16 activations, where one rounding flip of an
# activation propagates through every later layer
LM_LOGIT_GATE = 3e-2
# the same with float32 activations (on the same bf16-valued weights),
# where the kernels and the plain versions differ by float32 rounding only
LM_F32_LOGIT_GATE = 1e-4
# mamba2-370m's bf16 logits, 48 layers deep: the reference's own gap between
# its kernel path (the RMSNorm kernel in interpret mode) and its plain path
# on the CPU at 48 layers and mamba2's d_model 1024 (vocab, state and head
# dim reduced), the prefill and first decode step of 64-token prompts over 8
# seeds, is at most 0.0856 of max|ref| (tests/mamba2_bf16_gap.py --d-model
# 1024 --seeds 8; PERF.md §6; tests/test_torch_ssm.py holds the port to
# the same gate); the gate is 1.5 times that gap
MAMBA2_BF16_GAP = 0.0856
MAMBA2_BF16_LOGIT_GATE = 1.5 * MAMBA2_BF16_GAP

KERNEL_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_fused.cu"
KERNEL_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:217"
DW_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_fused_dw.cu"
DW_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:307"
RMSNORM_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
RMSNORM_REPLACES = "src/repro/kernels/rmsnorm/kernel.py:24"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:82"
FLAT_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_apply.cu"
FLAT_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:101"
FLAT_DW_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_dw.cu"
FLAT_DW_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:140"
# sources whose ptxas report (registers, shared memory, spills) phase 1 prints
REPORTED_SOURCES = (FLASH_SOURCE, KERNEL_SOURCE, DW_SOURCE, FLAT_SOURCE, RMSNORM_SOURCE)
# The first versions' recorded times (PERF.md §6 rows 3 and 5; NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside the redesigned kernels' in phases 2b
# and 8: the flattened-K mix (between CUDA events around one call, ms:
# forward, dx) and RMSNorm (device time from torch.profiler, us: low, high
# of the recorded runs)
FLAT_FIRST_MS = {"full b=2": (1.799, 1.815), "full b=1": (1.408, 1.299),
                 "shard P=4 b=2": (0.572, 0.513)}
RMSNORM_FIRST_US = {(1000, 3072): (4.36, 4.36), (4, 3072): (2.36, 2.44),
                    (1000, 2048): (3.37, 3.37), (4, 2048): (1.98, 1.98),
                    (1000, 512): (2.70, 2.72), (4, 512): (1.91, 1.93),
                    (1000, 1024): (2.70, 2.73), (4, 1024): (1.71, 1.73),
                    (1000, 2560): (4.65, 4.70), (4, 2560): (2.74, 2.87)}
# An empty kernel, built in phase 1 beside the port's and timed in phase 8:
# what any launch costs, the floor under a kernel of microseconds (not a
# kernel of the port)
EMPTY_KERNEL_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median time of ``fn`` in milliseconds from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_loop_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Time per call of ``fn`` in milliseconds, from CUDA events around ``n``
    back-to-back calls (median of ``reps``): for kernels of microseconds,
    where events around a single launch would time the launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def _kernel_trace(fn, calls: int) -> tuple:
    """(ms, kernels): the union of the kernels' spans and their number over
    ``calls`` calls of ``fn`` under ``torch.profiler``. The profiler can hand
    a trace's kernel events to the next trace instead, so an empty trace
    before takes what earlier traces left, and one after is read with this
    one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_forward import profile_spans, union_ms

    def empty():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
        return prof

    empty()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted(profile_spans(prof) + profile_spans(empty()))
    return union_ms(spans), len(spans)


def device_ms(fn, n: int = 20) -> tuple:
    """(ms, timed_by): device time per call of ``fn`` in milliseconds, the
    union of its kernels' spans in a ``torch.profiler`` trace of ``n``
    calls, over ``n``, and ``"profiler"``. For a kernel of microseconds the
    host's launch overhead outlasts the kernel, so CUDA events around
    back-to-back calls time the host; the trace times the device alone.
    A trace can miss kernel events: a one-call trace is taken again while
    it holds none, and an ``n``-call trace is used only when it holds at
    least ``n`` times the kernels of the one-call trace (which, missing
    some itself, may hold fewer than a call launches), and is taken again
    otherwise; after three such, the time comes from CUDA events around
    back-to-back calls, an upper bound, with ``"events"``, and the script
    says so."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        per_call = _kernel_trace(fn, 1)[1]
        if per_call:
            break
    for _ in range(3):
        busy, kernels = _kernel_trace(fn, n)
        if per_call and kernels >= n * per_call:
            return busy / n, "profiler"
        print(f"[timing] a trace of {n} calls held {kernels} kernels, want at least {n} x "
              f"{per_call}: taken again")
    print("[timing] three traces missed kernel events; timed by CUDA events instead")
    return cuda_loop_ms(fn, n=n), "events"


def _ptxas_reports(tmp: str) -> list:
    """Start one ``nvcc -Xptxas -v`` compile of each of ``REPORTED_SOURCES``
    (the build's target flags, object into ``tmp``); returns the processes."""
    from torch.utils import cpp_extension

    from repro_torch.kernels.build import CUDA_CFLAGS

    if cpp_extension.CUDA_HOME is None:
        raise SystemExit("[ptxas] no CUDA toolkit with nvcc was found (set CUDA_HOME)")
    nvcc = os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc")
    return [(src, subprocess.Popen(
        [nvcc, *CUDA_CFLAGS, "-std=c++17", "-Xptxas", "-v", "-c", os.path.join(ROOT, src),
         "-o", os.path.join(tmp, f"{i}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for i, src in enumerate(REPORTED_SOURCES)]


def _ptxas_summary(out: str) -> list:
    """One line per kernel of an ``-Xptxas -v`` report: its name (demangled
    where ``c++filt`` exists), registers, spills and static shared memory
    (dynamic shared memory is set at launch, so ptxas cannot report it)."""
    kernels, name = [], None
    for line in out.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spills = m.group(1), ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            kernels.append((name, f"{regs.group(1) if regs else '?'} registers; {spills}; "
                                  f"{smem.group(1) if smem else 0} bytes static smem"))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(k for k, _ in kernels),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(kernels):
        names = [k for k, _ in kernels]
    return [f"{n}: {info}" for n, (_, info) in zip(names, kernels)]


def _empty_kernel_library():
    """``EMPTY_KERNEL_SOURCE`` as a kernel library under the build directory."""
    from repro_torch.kernels.build import BUILD_DIR, KernelLibrary

    src_dir = os.path.join(BUILD_DIR, "launch_floor_src")
    os.makedirs(src_dir, exist_ok=True)
    path = os.path.join(src_dir, "launch_floor.cu")
    with open(path, "w") as f:
        f.write(EMPTY_KERNEL_SOURCE)
    return KernelLibrary("repro_torch_launch_floor", (path,))


def phase_build() -> float:
    import tempfile

    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.kernels.build import build
    from repro_torch.kernels.spectral_conv import build as spectral_build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reports = _ptxas_reports(tmp)
        paths = build([spectral_build.LIBRARY, rmsnorm.LIBRARY, flash_attention.LIBRARY,
                       _empty_kernel_library()])
        spectral_build.load_library()
        rmsnorm.ops.load_library()
        flash_attention.ops.load_library()
        dt = time.perf_counter() - t0
        for src, proc in reports:
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                print(out[-4000:], file=sys.stderr)
                raise SystemExit(f"[ptxas] nvcc -Xptxas -v of {src} exited {proc.returncode}")
            for line in _ptxas_summary(out):
                print(f"[ptxas] {os.path.basename(src)}: {line}")
    print(f"[build] {len(paths) - 1} kernel libraries and the empty kernel built/loaded in "
          f"{dt:.1f}s: "
          + ", ".join(os.path.basename(p) for p in paths))
    return dt


def _bound_ms(nbytes, flops) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the float32 operations over the FP32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fused_bound_ms(b, ci, co, ext, kept, t_in, t_out, with_add) -> tuple:
    """Bound of the fused op: w once, the kept part of x once, add once,
    the full output once; 8 flops per complex multiply-add."""
    n_kept = int(np.prod(kept))
    out_elems = b * co * ext[0] * ext[1] * ext[2] * t_out
    nbytes = 8 * (ci * co * n_kept + b * ci * n_kept + out_elems
                  + (b * co * n_kept if with_add else 0))
    return _bound_ms(nbytes, 8 * b * ci * co * n_kept)


def _dw_bound_ms(b, ci, co, kept) -> tuple:
    """Bound of the weight cotangent: the kept parts of x and g once, the
    weight gradient once; 8 flops per complex multiply-add."""
    n_kept = int(np.prod(kept))
    nbytes = 8 * (b * ci * n_kept + b * co * n_kept + ci * co * n_kept)
    return _bound_ms(nbytes, 8 * b * ci * co * n_kept)


def phase_kernels(gpu: str) -> dict:
    """CUDA spectral kernel vs its plain version; returns the record of the
    full-width block shape."""
    import torch

    from repro_torch.kernels.spectral_conv import (
        pad_kept_ref, spectral_apply_fused, spectral_apply_fused_add,
        spectral_apply_fused_ref,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    def spectrum(shape):
        """x as the serving path hands it to the kernel: the output of a 4-D
        rfftn, which cuFFT returns with permuted strides."""
        nt = 2 * (shape[-1] - 1)
        real = torch.randn(shape[:-1] + (nt,), device=dev, generator=gen)
        return torch.fft.rfftn(real, dim=(2, 3, 4, 5))

    # (name, b, ci, co, dims [(N or None, K)], t_in, kt, t_out, add, x from rfftn)
    cases = [
        ("trunc NNN, t tail", 2, 3, 5, [(16, 6), (12, 4), (8, 4)], 9, 3, 9, False, False),
        ("trunc NNN, no tail, add, b=5", 5, 4, 3, [(10, 4), (8, 2), (6, 6)], 4, 4, None, True, False),
        ("trunc N--, t tail", 2, 3, 5, [(16, 6), (None, 4), (None, 3)], 5, 3, 7, False, False),
        ("trunc N--, add", 1, 6, 2, [(12, 8), (None, 2), (None, 5)], 6, 2, 6, True, False),
        ("trunc N-N, no tail", 3, 4, 4, [(10, 4), (None, 4), (8, 2)], 3, 3, None, False, False),
        ("trunc N-N, t tail, add", 2, 5, 3, [(9, 4), (None, 3), (7, 6)], 5, 4, 8, True, False),
        ("trunc NNN, rfftn layout, add", 2, 3, 4, [(12, 4), (10, 6), (8, 2)], 7, 3, 7, True, True),
        ("serving block", 2, 40, 40, [(128, 48), (64, 32), (32, 16)], 45, 10, 45, False, True),
        ("serving block, add", 2, 40, 40, [(128, 48), (64, 32), (32, 16)], 45, 10, 45, True, True),
    ]
    worst = 0.0
    record = None
    for name, b, ci, co, dims, t_in, kt, t_out, with_add, from_fft in cases:
        trunc = tuple(n for n, _ in dims)
        ext = tuple(k if n is None else n for n, k in dims)
        kept = tuple(k for _, k in dims) + (kt,)
        xf = (spectrum if from_fft else rand)((b, ci) + ext + (t_in,))
        w = rand((ci, co) + kept)
        add = rand((b, co) + kept) if with_add else None
        if add is None:
            got = spectral_apply_fused(xf, w, trunc, t_out=t_out)
        else:
            got = spectral_apply_fused_add(xf, w, add, trunc, t_out=t_out)
        torch.cuda.synchronize()
        ref = spectral_apply_fused_ref(xf, w, trunc, t_out)
        if add is not None:
            ref = ref + pad_kept_ref(add, trunc, t_out)
        if got.shape != ref.shape:
            raise SystemExit(f"[kernel] {name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        gate = TOL_REL * scale + TOL_ABS
        print(f"[kernel] {name}: max|d|={err:.3e} (gate {gate:.3e}, max|ref|={scale:.3e}); "
              f"x strides {xf.stride()}")
        if not err <= gate:
            raise SystemExit(f"[kernel] {name}: kernel disagrees with its plain version")
        worst = max(worst, err / max(scale, 1e-30))
        if name == "serving block":
            ms = cuda_ms(lambda: spectral_apply_fused(xf, w, trunc, t_out=t_out))
            # the same inputs in contiguous layout: what reading cuFFT's
            # permuted spectrum through its strides costs the kernel
            xc = xf.contiguous()
            contiguous_ms = cuda_ms(lambda: spectral_apply_fused(xc, w, trunc, t_out=t_out))
            del xc
            plain_ms = cuda_ms(lambda: spectral_apply_fused_ref(xf, w, trunc, t_out), iters=5)
            bound_ms, bound_by = _fused_bound_ms(b, ci, co, ext, kept, t_in, t_out, False)
            print(
                f"[kernel] serving block: kernel {ms:.3f} ms ({contiguous_ms:.3f} ms on a "
                f"contiguous x), plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); {gpu}"
            )
            record = {
                "name": "spectral_fused",
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": KERNEL_REPLACES,
                "launches": None,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
        del xf, w, add, got, ref
        torch.cuda.empty_cache()
    print(f"[kernel] worst relative error over all cases: {worst:.3e}")
    return record


def _irfftn_cotangent(shape, dev, gen):
    """A cotangent g of the fused op's output as the training path hands it
    over: the gradient that the irfftn backward produces for its input."""
    import torch

    nt = 2 * (shape[-1] - 1)
    yf = torch.zeros(shape, dtype=torch.complex64, device=dev, requires_grad=True)
    y = torch.fft.irfftn(yf, s=tuple(shape[2:5]) + (nt,), dim=(2, 3, 4, 5))
    y.backward(torch.randn(y.shape, device=dev, generator=gen))
    return yf.grad


def _gate(tag, got, ref) -> float:
    """Fail unless max|got - ref| <= 1e-4 max|ref| + 1e-6; returns the error."""
    if tuple(got.shape) != tuple(ref.shape):
        raise SystemExit(f"[{tag}] shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    gate = TOL_REL * scale + TOL_ABS
    print(f"[{tag}] max|d|={err:.3e} (gate {gate:.3e}, max|ref|={scale:.3e})")
    if not err <= gate:
        raise SystemExit(f"[{tag}] disagrees with its plain version")
    return err


def phase_backward_kernels(gpu: str) -> tuple:
    """The weight-cotangent kernel and the fused op's backward vs their
    plain versions; both backward kernels timed at the training block
    shape. Returns (dx timing record, dW kernel record)."""
    import torch

    from repro_torch.configs.fno_sleipner import CONFIG, ONE_CARD_TRAIN_BATCH, ONE_CARD_TRAIN_ACCUM
    from repro_torch.configs.fno_sleipner import ONE_CARD_TRAIN_GRID
    from repro_torch.kernels.spectral_conv import (
        pad_kept_ref, spectral_apply_fused, spectral_apply_fused_add,
        spectral_apply_fused_ref, spectral_fused_dw, spectral_fused_dw_ref,
        spectral_fused_dx,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    def spectrum(shape):
        nt = 2 * (shape[-1] - 1)
        real = torch.randn(shape[:-1] + (nt,), device=dev, generator=gen)
        return torch.fft.rfftn(real, dim=(2, 3, 4, 5))

    # (name, b, ci, co, dims [(N or None, K)], t_x, t_g, kt, layouts from the FFTs)
    cases = [
        ("dw NNN, t tails", 2, 3, 5, [(16, 6), (12, 4), (8, 4)], 9, 7, 3, False),
        ("dw NNN, FFT layouts", 3, 4, 3, [(12, 4), (10, 6), (8, 2)], 7, 7, 3, True),
        ("dw N--, t tail", 2, 3, 5, [(16, 6), (None, 4), (None, 3)], 5, 3, 3, False),
        ("dw N-N, t tails", 5, 2, 4, [(10, 4), (None, 4), (8, 2)], 4, 6, 3, False),
    ]
    for name, b, ci, co, dims, t_x, t_g, kt, from_fft in cases:
        trunc = tuple(n for n, _ in dims)
        ext = tuple(k if n is None else n for n, k in dims)
        kept = tuple(k for _, k in dims) + (kt,)
        if from_fft:
            xf = spectrum((b, ci) + ext + (t_x,))
            g = _irfftn_cotangent((b, co) + ext + (t_g,), dev, gen)
        else:
            xf, g = rand((b, ci) + ext + (t_x,)), rand((b, co) + ext + (t_g,))
        got = spectral_fused_dw(xf, g, trunc, kept)
        torch.cuda.synchronize()
        _gate(f"kernel {name}", got, spectral_fused_dw_ref(xf, g, trunc, kept))
        print(f"[kernel] {name}: x strides {xf.stride()}, g strides {g.stride()}")

    # the autograd Function vs plain autograd on the same inputs
    for name, dims, t_in, kt, t_out, with_add in (
        ("backward NNN, t tail", [(16, 6), (12, 4), (8, 4)], 9, 3, 9, False),
        ("backward N-N, add", [(10, 4), (None, 4), (8, 2)], 4, 3, 6, True),
    ):
        trunc = tuple(n for n, _ in dims)
        ext = tuple(k if n is None else n for n, k in dims)
        kept = tuple(k for _, k in dims) + (kt,)
        inputs = [spectrum((2, 3) + ext + (t_in,)), rand((3, 4) + kept)]
        if with_add:
            inputs.append(rand((2, 4) + kept))
        a = torch.randn((2, 4) + ext + (t_out,), device=dev, generator=gen)

        def grads(plain):
            leaves = [t.clone().requires_grad_() for t in inputs]
            if plain:
                y = spectral_apply_fused_ref(leaves[0], leaves[1], trunc, t_out)
                if with_add:
                    y = y + pad_kept_ref(leaves[2], trunc, t_out)
            elif with_add:
                y = spectral_apply_fused_add(*leaves, trunc, t_out=t_out)
            else:
                y = spectral_apply_fused(*leaves, trunc, t_out=t_out)
            (y.real * a - y.imag * a).sum().backward()
            return [t.grad for t in leaves]

        for i, (got, ref) in enumerate(zip(grads(False), grads(True))):
            _gate(f"kernel {name}, grad of input {i}", got, ref)

    # the training block: micro-batch of the main path, layouts of its FFTs
    b = ONE_CARD_TRAIN_BATCH // ONE_CARD_TRAIN_ACCUM
    ci = co = CONFIG.width
    ext = ONE_CARD_TRAIN_GRID[:3]
    t_bins = ONE_CARD_TRAIN_GRID[3] // 2 + 1
    kept = CONFIG.mode_shape
    trunc = ext
    xf = spectrum((b, ci) + ext + (t_bins,))
    g = _irfftn_cotangent((b, co) + ext + (t_bins,), dev, gen)
    w = rand((ci, co) + kept)
    print(f"[kernel] training block b={b} ci={ci} co={co} E={ext} T={t_bins} K={kept}: "
          f"x strides {xf.stride()} (rfftn), g strides {g.stride()} (irfftn backward)")
    dw_ref = spectral_fused_dw_ref(xf, g, trunc, kept)
    dw_got = spectral_fused_dw(xf, g, trunc, kept)
    dw_err = _gate("kernel training block dW", dw_got, dw_ref)
    if not torch.equal(dw_got, spectral_fused_dw(xf, g, trunc, kept)):
        raise SystemExit("[kernel] training block dW: two launches on the same inputs differ")
    del dw_got
    # the same values in contiguous layout
    xc, gc = xf.contiguous(), g.contiguous()
    _gate("kernel training block dW, contiguous operands",
          spectral_fused_dw(xc, gc, trunc, kept), dw_ref)
    del dw_ref
    wt = w.transpose(0, 1).conj()
    dx_err = _gate("kernel training block dx",
                   spectral_fused_dx(g, w, trunc, t_bins),
                   spectral_apply_fused_ref(g, wt, trunc, t_bins))
    torch.cuda.empty_cache()
    dw_ms = cuda_ms(lambda: spectral_fused_dw(xf, g, trunc, kept))
    dw_contiguous_ms = cuda_ms(lambda: spectral_fused_dw(xc, gc, trunc, kept))
    # the store floor: writing a tensor of w's size, and nothing else
    store_floor_ms = cuda_ms(lambda: torch.empty((ci, co) + kept, dtype=torch.complex64,
                                                 device=dev).zero_())
    del xc, gc
    dw_plain = cuda_ms(lambda: spectral_fused_dw_ref(xf, g, trunc, kept), iters=5)
    dx_ms = cuda_ms(lambda: spectral_fused_dx(g, w, trunc, t_bins))
    dx_plain = cuda_ms(lambda: spectral_apply_fused_ref(g, wt, trunc, t_bins), iters=5)
    dw_bound, dw_by = _dw_bound_ms(b, ci, co, kept)
    dx_bound, dx_by = _fused_bound_ms(b, co, ci, ext, kept, t_bins, t_bins, False)
    print(f"[kernel] training block dW: kernel {dw_ms:.3f} ms on the FFT layouts, "
          f"{dw_contiguous_ms:.3f} ms on contiguous operands; zero_() of a w-sized tensor "
          f"{store_floor_ms:.3f} ms (the store floor); plain {dw_plain:.3f} ms, "
          f"bound {dw_bound:.3f} ms ({dw_by}); {gpu}")
    print(f"[kernel] training block dx (fused kernel on conj(W^T)): kernel {dx_ms:.3f} ms, "
          f"plain {dx_plain:.3f} ms, bound {dx_bound:.3f} ms ({dx_by}); {gpu}")
    del xf, g, w, wt
    torch.cuda.empty_cache()
    dx = {"train_dx_ms": dx_ms, "train_dx_plain_ms": dx_plain, "train_dx_bound_ms": dx_bound,
          "train_dx_max_abs_err": dx_err}
    record = {
        "name": "spectral_fused_dw",
        "route": "cuda",
        "source": DW_SOURCE,
        "replaces": DW_REPLACES,
        "launches": None,
        "max_abs_err": dw_err,
        "ms": dw_ms,
        "plain_ms": dw_plain,
        "bound_ms": dw_bound,
        "bound_by": dw_by,
        "library_ms": None,
        "store_floor_ms": store_floor_ms,
    }
    return dx, record


def _flat_bound_ms(b, ci, co, k) -> tuple:
    """Bound of the flattened-K mix (and of its weight cotangent, which
    moves the same bytes): x [b, ci, K] and w [ci, co, K] read once, y [b,
    co, K] written once; 8 flops per complex multiply-add."""
    return _bound_ms(8 * k * (b * ci + ci * co + b * co), 8 * b * ci * co * k)


def _all_launch_counters():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.spectral_conv import (
        spectral_apply_cuda, spectral_dw_cuda, spectral_fused_cuda, spectral_fused_dw_cuda,
    )

    return {"spectral_fused": spectral_fused_cuda, "spectral_fused_dw": spectral_fused_dw_cuda,
            "spectral_apply": spectral_apply_cuda, "spectral_dw": spectral_dw_cuda,
            "rmsnorm": rmsnorm_cuda, "flash_attention": flash_attention_cuda}


def phase_flat_kernels(gpu: str) -> tuple:
    """The flattened-K op ``spectral_apply``: both kernels and its autograd
    backward vs their plain versions, the mix kernel vs the fused kernel on
    pre-truncated modes, one forward + backward through the op at the
    Sleipner FNO's full kept-mode width with exact launch counts, and the
    kernels timed at the full-width and model-parallel shard shapes.
    Returns the two kernels' records."""
    import torch

    from repro_torch.configs.fno_sleipner import CONFIG
    from repro_torch.kernels.spectral_conv import (
        spectral_apply, spectral_apply_cuda, spectral_apply_dw, spectral_apply_dx,
        spectral_apply_fused, spectral_apply_ref, spectral_dw_cuda, spectral_dw_ref,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    def channels_outermost(z):
        return z.transpose(0, 1).contiguous().transpose(0, 1)

    # (name, b, ci, co, modes, channels outermost): 2-4 mode dims, K not a
    # multiple of 32 or 128, ci != co, b = 1-3 and past the batch chunk of 4;
    # K at the mix kernel's 64-mode tile and 16-byte pair edges (odd K takes
    # its 8-byte path), co past its 40-channel chunk, the P = 4 shard's mode
    # shape at reduced channels
    cases = [
        ("2 modes K=133", 1, 3, 5, (7, 19), False),
        ("3 modes K=165 permuted", 2, 9, 10, (3, 5, 11), True),
        ("4 modes K=210", 3, 4, 17, (2, 3, 5, 7), False),
        ("2 modes K=99 b=3 permuted", 3, 11, 9, (3, 33), True),
        ("4 modes K=1000 permuted", 2, 6, 13, (5, 4, 5, 10), True),
        ("1 mode K=300 b=6", 6, 5, 3, (300,), False),
        ("K=63 tile-1", 2, 7, 40, (63,), False),
        ("K=64 tile", 1, 40, 40, (8, 8), False),
        ("K=65 tile+1 permuted", 2, 5, 6, (5, 13), True),
        ("K=1 b=5", 5, 3, 41, (1,), False),
        ("K=2 co=81", 2, 3, 81, (2,), False),
        ("shard modes (48,8,16,10) at 8 channels", 2, 8, 8, (48, 8, 16, 10), False),
    ]
    for name, b, ci, co, modes, permuted in cases:
        x, w, g = rand((b, ci) + modes), rand((ci, co) + modes), rand((b, co) + modes)
        if permuted:
            x, w, g = channels_outermost(x), channels_outermost(w), channels_outermost(g)
        y = spectral_apply(x, w)
        _gate(f"flat {name} forward", y, spectral_apply_ref(x, w))
        dx = spectral_apply_dx(g, w)
        _gate(f"flat {name} dx", dx, spectral_apply_ref(g, w.transpose(0, 1).conj()))
        _gate(f"flat {name} dW", spectral_apply_dw(x, g), spectral_dw_ref(x, g))
        if not (torch.equal(y, spectral_apply(x, w)) and torch.equal(dx, spectral_apply_dx(g, w))):
            raise SystemExit(f"[flat] {name}: two runs of the mix kernel differ")
        print(f"[flat] {name}: x strides {x.stride()}, w strides {w.stride()}; forward and dx "
              f"bitwise the same over two runs")

    def grads(op, inputs, a):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y = op(*leaves)
        (y.real * a - y.imag * a).sum().backward()
        return y.detach(), [t.grad for t in leaves]

    # the autograd Function vs plain autograd, with exact launch counts
    for name, b, ci, co, modes, permuted in cases[1:3]:
        inputs = [rand((b, ci) + modes), rand((ci, co) + modes)]
        if permuted:
            inputs = [channels_outermost(t) for t in inputs]
        a = torch.randn((b, co) + modes, device=dev, generator=gen)
        before = (spectral_apply_cuda.launches, spectral_dw_cuda.launches)
        _, got = grads(spectral_apply, inputs, a)
        torch.cuda.synchronize()
        moved = (spectral_apply_cuda.launches - before[0], spectral_dw_cuda.launches - before[1])
        if moved != (2, 1):
            raise SystemExit(f"[flat] backward {name}: launches {moved}, want (2, 1)")
        for i, (gk, gp) in enumerate(zip(got, grads(spectral_apply_ref, inputs, a)[1])):
            _gate(f"flat backward {name}, grad of input {i}", gk, gp)

    # the Sleipner FNO's full kept-mode width, and its 1-D model-parallel shard
    ci = co = CONFIG.width
    full = tuple(CONFIG.mode_shape)
    shard = (full[0], full[1] // 4, full[2], full[3])
    xs = rand((2, ci) + full)
    w = rand((ci, co) + full)
    w_part = w[:4, :5].contiguous()
    cross = spectral_apply_fused(xs[:1, :4], w_part, (None, None, None))
    _gate("flat vs fused kernel, pre-truncated 4 modes", spectral_apply(xs[:1, :4], w_part), cross)
    cross = spectral_apply_fused(xs, w, (None, None, None))
    _gate("flat vs fused kernel at full width b=2", spectral_apply(xs, w), cross)
    del cross

    # the op's main path: one forward and backward at full width, b=2,
    # every kernel's count set to 0 just before and read just after
    a = torch.randn((2, co) + full, device=dev, generator=gen)
    counters = _all_launch_counters()
    for c in counters.values():
        c.launches = 0
    y, got = grads(spectral_apply, [xs, w], a)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: {"spectral_apply": 2, "spectral_dw": 1}.get(k, 0) for k in counters}
    print(f"[flat] full width b=2, K={int(np.prod(full))}: one forward + backward through "
          f"spectral_apply launched {launches}; {gpu}")
    if launches != want:
        raise SystemExit(f"[flat] the op's forward + backward launched {launches}, want {want}")
    if tuple(y.shape) != (2, co) + full or not bool(torch.isfinite(y).all()):
        raise SystemExit("[flat] full-width output has a wrong shape or non-finite values")
    y_ref, want_grads = grads(spectral_apply_ref, [xs, w], a)
    errs = {"forward": _gate("flat full width b=2 forward", y, y_ref)}
    if not torch.equal(y, spectral_apply(xs, w)):
        raise SystemExit("[flat] full width b=2: two forwards differ")
    for tag, gk, gp in zip(("dx", "dW"), got, want_grads):
        errs[tag] = _gate(f"flat full width b=2 {tag} (autograd vs plain autograd)", gk, gp)
    del y, y_ref, got, want_grads, a
    torch.cuda.empty_cache()

    # timings: kernel, plain version (one torch.einsum, also the library
    # call), and torch.bmm on the K-leading layout of the TPU wrapper
    timed = {}
    for tag, b, modes in (("full b=2", 2, full), ("full b=1", 1, full), ("shard P=4 b=2", 2, shard)):
        k = int(np.prod(modes))
        x = xs[:b] if modes == full else rand((b, ci) + modes)
        wt = w if modes == full else rand((ci, co) + modes)
        g = rand((b, co) + modes)
        # the mix kernel between CUDA events around one call, as its first
        # version was timed (which also times the wrapper's host work before
        # the launch), and back to back (CUDA events around 20 calls: the
        # device's pace, as its 0.3-1.3 ms outlast the wrapper's host work;
        # no torch.profiler here, whose first use in the process leaves the
        # traces of phase 8 missing kernels)
        fwd = cuda_ms(lambda: spectral_apply(x, wt))
        dx = cuda_ms(lambda: spectral_apply_dx(g, wt))
        fwd_loop = cuda_loop_ms(lambda: spectral_apply(x, wt), n=20, reps=3)
        dx_loop = cuda_loop_ms(lambda: spectral_apply_dx(g, wt), n=20, reps=3)
        dw = cuda_ms(lambda: spectral_apply_dw(x, g))
        plain_fwd = cuda_ms(lambda: spectral_apply_ref(x, wt))
        plain_dw = cuda_ms(lambda: spectral_dw_ref(x, g))
        x2 = x.reshape(b, ci, k).permute(2, 0, 1).contiguous()
        w2 = wt.reshape(ci, co, k).permute(2, 0, 1).contiguous()
        g2 = g.reshape(b, co, k).permute(2, 0, 1).contiguous()
        x2h = x2.conj().resolve_conj().transpose(1, 2)
        bmm_fwd = cuda_ms(lambda: torch.bmm(x2, w2))
        bmm_dw = cuda_ms(lambda: torch.bmm(x2h, g2))
        del x2, w2, g2, x2h
        torch.cuda.empty_cache()
        bound, by = _flat_bound_ms(b, ci, co, k)
        timed[tag] = dict(shape=f"x [{b}, {ci}, {', '.join(map(str, modes))}], w [{ci}, {co}, ...], "
                                f"K={k}, complex64",
                          ms=fwd, dx_ms=dx, loop_ms=fwd_loop, dx_loop_ms=dx_loop,
                          dw_ms=dw, plain_ms=plain_fwd, dw_plain_ms=plain_dw,
                          bmm_ms=bmm_fwd, dw_bmm_ms=bmm_dw, bound_ms=bound, bound_by=by)
        first = FLAT_FIRST_MS[tag]
        print(f"[flat] {tag} K={k}: mix kernel {fwd:.3f} ms between events around one call "
              f"({bound / fwd:.0%} of bound), dx {dx:.3f} ms ({bound / dx:.0%}) (the first "
              f"version's record, taken so: {first[0]:.3f}, dx {first[1]:.3f} ms); a call back "
              f"to back {fwd_loop:.3f} ms ({bound / fwd_loop:.0%}), dx {dx_loop:.3f} ms "
              f"({bound / dx_loop:.0%}); dW kernel {dw:.3f} ms; "
              f"plain (torch.einsum) {plain_fwd:.3f} / dW {plain_dw:.3f} ms; torch.bmm on the "
              f"K-leading layout {bmm_fwd:.3f} / dW {bmm_dw:.3f} ms; bound {bound:.3f} ms ({by}); {gpu}")
        del x, wt, g
    del xs, w
    torch.cuda.empty_cache()

    def record(name, source, replaces, prefix, err, n):
        t = timed["full b=2"]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": err, "ms": t[prefix + "ms"],
            "plain_ms": t[prefix + "plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t[prefix + "plain_ms"],
            "library_call": "torch.einsum, the plain version itself",
            "bmm_ms": t[prefix + "bmm_ms"], "shape": t["shape"],
            "other_shapes": {tag: {key: v[prefix + key] for key in ("ms", "plain_ms", "bmm_ms")}
                             | {"bound_ms": v["bound_ms"], "shape": v["shape"]}
                             for tag, v in timed.items() if tag != "full b=2"},
            "launches_by_path": {"spectral_apply forward + backward": n},
        }

    flat = record("spectral_apply", FLAT_SOURCE, FLAT_REPLACES, "", errs["forward"],
                  launches["spectral_apply"])
    flat["dx_ms"] = {tag: v["dx_ms"] for tag, v in timed.items()}
    flat["loop_ms"] = {tag: {"forward": v["loop_ms"], "dx": v["dx_loop_ms"]}
                       for tag, v in timed.items()}
    flat["dx_max_abs_err"] = errs["dx"]
    flat_dw = record("spectral_dw", FLAT_DW_SOURCE, FLAT_DW_REPLACES, "dw_", errs["dW"],
                     launches["spectral_dw"])
    return flat, flat_dw


def _serving_cfg(in_channels: int = 1):
    import dataclasses

    from repro_torch.configs.fno_sleipner import CONFIG, ONE_CARD_GRID

    return dataclasses.replace(CONFIG, grid=ONE_CARD_GRID, in_channels=in_channels)


def _check_launches(tag: str, launches: int, n_blocks: int, forwards: int, gpu: str) -> int:
    """Every forward of a served run launches the spectral kernel once per
    FNO block; fail otherwise."""
    print(f"[{tag}] spectral_fused launches: {launches} over {forwards} forwards "
          f"x {n_blocks} blocks; {gpu}")
    if forwards == 0 or launches != n_blocks * forwards:
        raise SystemExit(f"[{tag}] expected {n_blocks} x {forwards} spectral kernel "
                         f"launches, counted {launches}")
    return launches


def _report_serving(tag, done, dt, runner):
    import torch

    lat = sorted(r.finished_s - r.submitted_s for r in done)
    n = len(done)
    for r in done:
        for y in r.outputs:
            if y.shape != (runner.cfg.out_channels,) + runner.cfg.grid or not np.isfinite(y).all():
                raise SystemExit(f"[{tag}] rid {r.rid}: bad output shape {y.shape} or non-finite values")
    print(
        f"[{tag}] served {n} scenarios x {len(done[0].outputs)} steps in {dt:.3f}s: "
        f"{n / dt:.3f} scen/s, p50 latency {lat[n // 2] * 1e3:.1f} ms, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )


def _memory_line() -> str:
    """This process's allocated and reserved device memory and the card's
    free memory, for the lines printed where several processes share it."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return (f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, card free {free / 2**30:.2f} of "
            f"{total / 2**30:.2f} GiB")


def _free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# Rollout steps of the served ensemble (cut from 2 for the script's time)
SERVE_STEPS = 1
# The scheduler (or gateway) steps a served pass may take: each pass here
# needs a few
SCHED_MAX_STEPS = 100


def phase_serving(gpu: str) -> tuple:
    """Full-width Sleipner serving through FNORunner + Scheduler; returns the
    spectral kernel's launch count over the served run and its seconds a
    scenario."""
    import torch

    from repro_torch.configs.fno_sleipner import ONE_CARD_SLOTS
    from repro_torch.core.fno import init_params
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda
    from repro_torch.launch.serve_pde import build_scenarios, check_served, serve, verify
    from repro_torch.serve import FNORunner

    cfg = _serving_cfg()
    print("reduced: grid 256x128x64 -> 128x64x32")
    print(f"[serve] config {cfg}")
    dev = torch.device("cuda")
    _free_cuda()
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    nbytes = sum(t.numel() * t.element_size() for g in params.values() for t in g.values())
    print(f"[serve] weights on the card: {nbytes / 1e9:.2f} GB")
    runner = FNORunner(cfg, params, device=dev, max_slots=ONE_CARD_SLOTS)
    print(f"[serve] warmup of buckets {runner.buckets}: {runner.warmup():.2f}s")
    print(f"reduced: serve rollout steps 2 -> {SERVE_STEPS} (the script's time; one surrogate "
          f"application predicts a scenario's whole history)")
    requests, _ = build_scenarios(cfg, 4, 2, seed=0, steps=SERVE_STEPS)
    spectral_fused_cuda.launches = 0
    done, dt, sched = serve(runner, requests, ONE_CARD_SLOTS, SCHED_MAX_STEPS)
    launches = spectral_fused_cuda.launches
    check_served(done, requests, sched.failed)
    _report_serving("serve", done, dt, runner)
    _check_launches("serve", launches, cfg.n_blocks, runner.batched_steps, gpu)
    worst = verify(runner, done, SERVE_STEPS)
    print(f"[serve] verify OK vs the unfused plain forward (max abs diff {worst:.3e})")
    return launches, dt / len(done)


# Rollout steps and blocks of the one-card ensemble (cut from 2 and 4 for
# the script's time: a cold pass is the host prefix, the rest is ticks)
ENSEMBLE_STEPS, ENSEMBLE_BLOCKS = 1, 2


def phase_ensemble(gpu: str) -> dict:
    """The same size as a UQ ensemble through the deep-split geomodel cache;
    returns the spectral kernel's launch count of each pass."""
    import dataclasses

    import torch

    from repro_torch.configs.fno_sleipner import ONE_CARD_SLOTS
    from repro_torch.core.fno import init_params
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda
    from repro_torch.launch.serve_pde import build_scenarios, check_served, serve, verify
    from repro_torch.serve import FNORunner

    cfg = dataclasses.replace(_train_cfg(), in_channels=2, n_blocks=ENSEMBLE_BLOCKS)
    print(f"reduced: ensemble rollout steps 2 -> {ENSEMBLE_STEPS}, n_blocks 4 -> "
          f"{ENSEMBLE_BLOCKS} (the script's time; a cold pass is the host prefix and one tick)")
    print(f"reduced: ensemble grid {'x'.join(map(str, _serving_cfg().grid[:3]))} -> "
          f"{'x'.join(map(str, cfg.grid[:3]))} (the script's time: the cold pass is the host's "
          f"numpy prefix, 4x the work at the larger grid; the fleet phase serves this grid at "
          f"4 blocks)")
    dev = torch.device("cuda")
    _free_cuda()
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    runner = FNORunner(cfg, params, device=dev, max_slots=ONE_CARD_SLOTS, n_static=1,
                       cache_level="deep", cache_bytes=16 << 30)
    print(f"[ensemble] warmup of buckets {runner.buckets}: {runner.warmup():.2f}s")
    passes, launches = [], {}
    for tag in ("cold", "warm"):
        requests, _ = build_scenarios(cfg, ONE_CARD_SLOTS, 2, seed=0, steps=ENSEMBLE_STEPS,
                                      n_static=1)
        forwards = runner.batched_steps
        spectral_fused_cuda.launches = 0
        done, dt, sched = serve(runner, requests, ONE_CARD_SLOTS, SCHED_MAX_STEPS)
        launches[f"ensemble_{tag}"] = spectral_fused_cuda.launches
        check_served(done, requests, sched.failed)
        _report_serving(f"ensemble {tag}", done, dt, runner)
        _check_launches(f"ensemble {tag}", launches[f"ensemble_{tag}"], cfg.n_blocks,
                        runner.batched_steps - forwards, gpu)
        passes.append(sorted(done, key=lambda r: r.rid))
    stats = runner.cache.stats
    print(f"[ensemble] cache hit-rate {stats['hit_rate']:.3f} ({stats['hits']} hits / {stats['misses']} misses); {gpu}")
    if not stats["hit_rate"] > 0:
        raise SystemExit("[ensemble] the geomodel cache never hit")
    for cold, warm in zip(*passes):
        for a, b in zip(cold.outputs, warm.outputs):
            if not np.array_equal(a, b):
                raise SystemExit(f"[ensemble] rid {cold.rid}: cold and warm outputs differ")
    print("[ensemble] cold == warm bitwise")
    worst = verify(runner, passes[0], ENSEMBLE_STEPS)
    print(f"[ensemble] verify OK vs the unfused plain forward (max abs diff {worst:.3e})")
    return launches


def _serve_cli(tag: str, d: str, flags: list, n_blocks: int, gpu: str) -> int:
    """``serve_pde`` on the checkpoint in ``d`` as a subprocess with
    ``flags``; fails unless it exits 0 and launched the spectral kernel once
    per block per forward. Returns its launch count."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_pde", "--ckpt-dir", d,
           "--scenarios", "4", "--max-batch", "2", "--rollout-steps", "2", "--ensemble",
           "--dup", "2", "--verify"] + flags
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    print("\n".join(f"[{tag}] " + line for line in out.stdout.strip().splitlines()))
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"[{tag}] serve_pde exited {out.returncode}")
    m = re.search(r"spectral kernel launches: (\d+) over (\d+) forwards", out.stdout)
    if m is None:
        raise SystemExit(f"[{tag}] serve_pde printed no spectral kernel launch count")
    return _check_launches(tag, int(m.group(1)), n_blocks, int(m.group(2)), gpu)


def phase_cli(gpu: str) -> dict:
    """The serving CLI on a small checkpoint the port writes, with --verify:
    one replica, then the fleet (2 replicas behind the gateway, affinity
    routing, a file cache store, a step budget). Returns the spectral
    kernel's launch count of each served run."""
    import tempfile

    import torch

    from repro_torch.core.fno import FNOConfig, init_params
    from repro_torch.train import checkpoint

    _free_cuda()  # the subprocess needs the memory this process has cached
    cfg = FNOConfig(grid=(16, 8, 8, 8), modes=(4, 2, 2, 3), width=8, in_channels=2,
                    n_blocks=2, decoder_dim=16)
    with tempfile.TemporaryDirectory() as d:
        params = init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
        checkpoint.save(d, 1, {"params": params})
        with open(os.path.join(d, "fno_config.json"), "w") as f:
            json.dump({
                "grid": list(cfg.grid), "modes": list(cfg.modes), "width": cfg.width,
                "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
                "n_blocks": cfg.n_blocks, "decoder_dim": cfg.decoder_dim,
                "model_shards": [1], "normalized": ["x"], "normalizer": "meanstd",
                "x_stats": {"mean": [0.5, 0.1], "std": [1.2, 0.3]}, "y_stats": None,
            }, f)
        launches = {"cli": _serve_cli("cli", d, ["--bench-sequential"], cfg.n_blocks, gpu)}
        t = time.perf_counter()
        launches["fleet_cli"] = _serve_cli(
            "fleet cli", d, ["--replicas", "2", "--policy", "affinity", "--cache-store",
                             os.path.join(d, "store"), "--max-steps", "200"], cfg.n_blocks, gpu)
        print(f"[fleet cli] {time.perf_counter() - t:.1f}s")
    return launches


# The one-card fleet: replicas, scenarios (scenario i on geomodel i % 2),
# byte-identical duplicates of the first ones
FLEET_REPLICAS, FLEET_SCENARIOS, FLEET_DUPS = 2, 8, 2


def _fleet_inputs(cfg, n: int, dups: int = 0) -> list:
    """``n`` raw scenario inputs on two geomodels (scenario i on geomodel
    i % 2: ``build_scenarios``' and one drawn from the next seed, as the
    reference's fleet tests pin a second), each with its own wells, then
    ``dups`` byte-identical copies of the first ones."""
    from repro_torch.data.pde.two_phase import geomodel_channel
    from repro_torch.launch.serve_pde import build_scenarios

    base, _ = build_scenarios(cfg, n, 2, seed=0, steps=1, n_static=1)
    second = geomodel_channel(cfg.grid[:3], cfg.grid[3], seed=1)
    xs = []
    for r in base:
        x = r.x.copy()
        if r.rid % 2:
            x[:1] = second
        xs.append(x)
    return xs + [xs[j].copy() for j in range(dups)]


def _fleet_requests(xs) -> list:
    from repro_torch.serve import ScenarioRequest

    return [ScenarioRequest(rid=i, x=x, steps=1) for i, x in enumerate(xs)]


class _Timed:
    """Seconds of each call of ``obj.name``, kept in ``calls``; the method is
    wrapped on the instance and called through."""

    def __init__(self, obj, name: str):
        self.calls, fn = [], getattr(obj, name)

        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.calls.append(time.perf_counter() - t)

        setattr(obj, name, timed)


def _replica_launches(gw) -> dict:
    """Each replica's spectral kernel launches and forwards from here on,
    counted around its scheduler steps (the counter is the wrapper's)."""
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda

    counts = {h.name: {"launches": 0, "forwards": 0} for h in gw.replicas}
    for h in gw.replicas:
        def tick(h=h, step=h.tick):
            launches, forwards = spectral_fused_cuda.launches, h.runner.batched_steps
            n = step()
            counts[h.name]["launches"] += spectral_fused_cuda.launches - launches
            counts[h.name]["forwards"] += h.runner.batched_steps - forwards
            return n

        h.tick = tick
    return counts


def _digest_s(runner) -> float:
    """Seconds to compute ``runner.cache_version`` (computed once, kept)."""
    t = time.perf_counter()
    runner.cache_version  # noqa: B018 - the property computes and keeps the digest
    return time.perf_counter() - t


def _latency(done) -> tuple:
    lat = sorted(r.finished_s - r.submitted_s for r in done)
    return len(done), lat[len(lat) // 2]


def _fleet_wave(tag, gw, xs, gpu) -> tuple:
    """One wave of ``xs`` through the gateway: (served by rid, seconds,
    each replica's launches and forwards)."""
    import torch

    from repro_torch.kernels.spectral_conv import spectral_fused_cuda
    from repro_torch.launch.serve_pde import check_served

    counts = _replica_launches(gw)
    reqs = _fleet_requests(xs)
    before = len(gw.finished)
    spectral_fused_cuda.launches = 0
    for r in reqs:
        gw.submit(r)
    t = time.perf_counter()
    gw.run_until_done(max_steps=SCHED_MAX_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    total = spectral_fused_cuda.launches
    done = gw.finished[before:]
    check_served(done, reqs, gw.failed)
    n, p50 = _latency(done)
    print(f"[{tag}] served {n} scenarios in {dt:.3f}s: {n / dt:.3f} scen/s, p50 latency "
          f"{p50 * 1e3:.1f} ms; routed " + ", ".join(
              f"{h.name} {h.routed}" for h in gw.replicas) + f"; rerouted {gw.rerouted}; {gpu}")
    for name, c in counts.items():
        if c["forwards"]:
            _check_launches(f"{tag} {name}", c["launches"], gw.replicas[0].runner.cfg.n_blocks,
                            c["forwards"], gpu)
    return {r.rid: r for r in done}, dt, counts, total


def phase_fleet(gpu: str) -> dict:
    """``_fleet``, then the card freed of everything it made (its runners'
    timing wrappers are reference cycles: collected here, once its frame
    is gone)."""
    out = _fleet(gpu)
    _free_cuda()
    return out


def _fleet(gpu: str) -> dict:
    """Two full-width replicas behind the gateway on one card (affinity
    routing, one fixed bucket, a file cache store). One plain ``FNORunner``
    first serves 8 scenarios over two geomodels plus 2 duplicates,
    computing both geomodels (its store lookups miss) and publishing them;
    the replicas, their caches empty, serve the same wave from the store,
    bitwise as the single runner; then a second wave after the replica
    that served geomodel 0 raises, failed over to the survivor, which hits
    the store; then ``serve_open_loop`` with per-replica executors and with
    one shared executor. Returns the spectral kernel's launch count of each
    wave."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs.fno_sleipner import ONE_CARD_SLOTS
    from repro_torch.core.fno import init_params
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda
    from repro_torch.launch.serve_pde import check_served, serve, verify
    from repro_torch.serve import FileCacheStore, FNORunner, Gateway, serve_open_loop

    cfg = dataclasses.replace(_train_cfg(), in_channels=2)
    print(f"reduced: fleet grid 256x128x64 -> {'x'.join(map(str, cfg.grid[:3]))} (two full-width "
          f"replicas share one card: 2 x 12.6 GB of w_spec)")
    dev = torch.device("cuda")
    _free_cuda()
    t = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    xs = _fleet_inputs(cfg, FLEET_SCENARIOS, FLEET_DUPS)
    print(f"[fleet] weights and {len(xs)} inputs made in {time.perf_counter() - t:.2f}s")
    kw = dict(device=dev, max_slots=ONE_CARD_SLOTS, buckets=(ONE_CARD_SLOTS,), n_static=1,
              cache_level="deep", cache_bytes=16 << 30)

    out = {}
    with tempfile.TemporaryDirectory() as d:
        store = FileCacheStore(os.path.join(d, "store"))
        puts, gets = _Timed(store, "put"), _Timed(store, "get")
        # one plain runner on replica 0's weights serves the same requests;
        # it computes both geomodels itself (its store lookups miss) and
        # publishes them
        t = time.perf_counter()
        single = FNORunner(cfg, params, cache_store=store, **kw)
        made_s = time.perf_counter() - t
        print(f"[fleet] single runner made in {made_s:.2f}s (block 0's weights to the host), "
              f"warmed in {single.warmup():.2f}s")
        digest_s = [_digest_s(single)]
        prefix = [_Timed(single, name) for name in ("_np_spectra", "_np_contribution")]
        reqs = _fleet_requests(xs)
        spectral_fused_cuda.launches = 0
        done, single_dt, sched = serve(single, reqs, ONE_CARD_SLOTS, SCHED_MAX_STEPS)
        check_served(done, reqs, sched.failed)
        _check_launches("fleet single", spectral_fused_cuda.launches, cfg.n_blocks,
                        single.batched_steps, gpu)
        want = {r.rid: r.outputs for r in done}
        single_rate = single.cache.stats["hit_rate"]
        n, p50 = _latency(done)
        print(f"[fleet] single runner: served {n} scenarios in {single_dt:.3f}s: "
              f"{n / single_dt:.3f} scen/s, p50 latency {p50 * 1e3:.1f} ms, cache hit-rate "
              f"{single_rate:.3f}, dedup attached {sched.dedup_attached}; {gpu}")
        for i, t in enumerate(single.tick_times):
            print(f"[fleet] single tick {i}: " + ", ".join(
                f"{k} {v:.3f}s" for k, v in t.items()) + f"; {gpu}")
        print("[fleet] a geomodel's cold prefix on the host (numpy): spectra " + ", ".join(
            f"{t:.3f}" for t in prefix[0].calls) + " s; block-0 mix " + ", ".join(
            f"{t:.3f}" for t in prefix[1].calls) + f" s; the store's version digest (blake2b "
            f"over block 0's weights, once a runner, before it serves) {digest_s[0]:.3f} s")
        entry_mb = store.stats["bytes"] / max(1, store.stats["entries"]) / 1e6
        print("[fleet] cache store (.npz files): put " + ", ".join(
            f"{t:.3f}" for t in puts.calls) + f" s of {entry_mb:.0f} MB entries")
        del single, done, sched, reqs

        twin = {g: {k: t.clone() for k, t in leaves.items()} for g, leaves in params.items()}
        replicas = [FNORunner(cfg, p, cache_store=store, **kw) for p in (params, twin)]
        del twin
        warm_s = sum(r.warmup() for r in replicas)
        # each replica's digest on a thread of its own, as each replica's
        # host would compute it (blake2b releases the GIL)
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=FLEET_REPLICAS) as pool:
            digest_s += list(pool.map(_digest_s, replicas))
        print(f"[fleet] {FLEET_REPLICAS} replicas made and warmed ({warm_s:.2f}s of warmup; "
              f"version digests " + ", ".join(f"{t:.3f}" for t in digest_s[1:]) + " s, "
              f"{time.perf_counter() - t:.3f} s together), no geomodel in their caches; "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        gw = Gateway(replicas, policy="affinity")
        served, fleet_dt, counts, out["fleet"] = _fleet_wave("fleet", gw, xs, gpu)
        for rid, r in served.items():
            if len(r.outputs) != len(want[rid]) or not all(
                    np.array_equal(a, b) for a, b in zip(r.outputs, want[rid])):
                raise SystemExit(f"[fleet] rid {rid}: the fleet's output differs from the "
                                 f"single runner's")
        print("[fleet] every replica's outputs (geomodels from the store) bitwise equal to the "
              "single runner's (geomodels computed)")
        keys = [{h.runner.affinity_key(r) for r in h.sched.finished} for h in gw.replicas]
        if not all(len(k) == 1 for k in keys) or keys[0] == keys[1]:
            raise SystemExit(f"[fleet] the two geomodels were not pinned to different "
                             f"replicas: {[len(k) for k in keys]} key(s) a replica")
        fleet = gw.stats()["fleet"]
        print(f"[fleet] geomodels pinned to different replicas; fleet cache hit-rate "
              f"{fleet['cache_hit_rate']:.3f} vs the single runner's {single_rate:.3f}; dedup "
              f"attached {fleet['dedup_attached']}")
        if abs(fleet["cache_hit_rate"] - single_rate) > 0.05:
            raise SystemExit("[fleet] the fleet's hit-rate is not within 0.05 of the single "
                             "runner's")
        for r, rep in enumerate(replicas):
            for i, t in enumerate(rep.tick_times):
                print(f"[fleet] r{r} tick {i}: " + ", ".join(
                    f"{k} {v:.3f}s" for k, v in t.items()) + f"; {gpu}")
        print("[fleet] cache store gets " + ", ".join(f"{t:.3f}" for t in gets.calls) + " s")

        # replica r0 (geomodel 0's) fails; the second wave goes to the survivor
        dead, hits, n_gets = gw.replicas[0], store.hits, len(gets.calls)

        def dead_step(slots, active):
            raise RuntimeError("simulated replica failure")

        dead.runner.step = dead_step
        again, _, _, out["fleet_failover"] = _fleet_wave("fleet failover", gw, xs, gpu)
        print("[fleet failover] store gets " + ", ".join(f"{t:.3f}" for t in gets.calls[n_gets:])
              + f" s; store {store.stats['hits']} hits / {store.stats['misses']} misses")
        if dead.healthy or gw.rerouted == 0 or store.hits <= hits:
            raise SystemExit(f"[fleet failover] no failover to a store hit (r0 healthy "
                             f"{dead.healthy}, rerouted {gw.rerouted}, store hits "
                             f"{hits} -> {store.hits})")
        for rid, r in again.items():
            if not all(np.array_equal(a, b) for a, b in zip(r.outputs, served[rid].outputs)):
                raise SystemExit(f"[fleet failover] rid {rid}: second wave differs from the first")
        print("[fleet failover] r0 failed, its requests rerouted to r1, which hit the store; "
              "second wave bitwise equal to the first")
        del dead.runner.step

        # the event clock: per-replica executors (each replica its own host,
        # the deployment model) and one shared executor (what this card
        # did), over a burst of one bucket a geomodel (warm caches)
        burst = xs[:2 * ONE_CARD_SLOTS]
        for per_replica, what in ((True, "per-replica executors (the event clock's "
                                   "deployment model)"),
                                  (False, "one shared executor (what this card did)")):
            rep_ol = serve_open_loop(Gateway(replicas, policy="affinity"),
                                     _fleet_requests(burst), [0.0] * len(burst),
                                     per_replica_executors=per_replica)
            if rep_ol.n_served != len(burst):
                raise SystemExit(f"[fleet] open loop served {rep_ol.n_served}/{len(burst)}")
            print(f"[fleet] serve_open_loop, {what}: makespan {rep_ol.makespan_s:.3f}s, "
                  f"{rep_ol.scen_per_s:.3f} scen/s, p50 {rep_ol.percentile(0.5) * 1e3:.1f} ms "
                  f"over {rep_ol.ticks} ticks; {gpu}")
        t = time.perf_counter()
        worst = verify(replicas[0], list(served.values()), 1)
        print(f"[fleet] verify OK vs the unfused plain forward (max abs diff {worst:.3e}) in "
              f"{time.perf_counter() - t:.2f}s")
    return out


def _train_cfg():
    import dataclasses

    from repro_torch.configs.fno_sleipner import CONFIG, ONE_CARD_TRAIN_GRID

    return dataclasses.replace(CONFIG, grid=ONE_CARD_TRAIN_GRID)


def phase_train(gpu: str) -> dict:
    """Full-width training on one card: every leaf's gradient through the
    fused path against the unfused forward's, then 4 steps of the train
    step. Returns each kernel's launch count over the 4 steps."""
    import torch

    from repro_torch.configs.fno_sleipner import ONE_CARD_TRAIN_ACCUM, ONE_CARD_TRAIN_BATCH
    from repro_torch.core.fno import fno_forward, fno_forward_unfused, init_params, mse_loss
    from repro_torch.data.loader import NdArraySource, ShardedDatasetLoader
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda, spectral_fused_dw_cuda
    from repro_torch.launch.train import synthetic_fno_data
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, warmup_cosine
    from repro_torch.train.train_loop import accumulate_grads, make_train_step, zeros_like_tree

    cfg = _train_cfg()
    steps, accum = 4, ONE_CARD_TRAIN_ACCUM
    print("reduced: grid 256x128x64 -> 64x32x32")
    print(f"[train] config {cfg}; batch {ONE_CARD_TRAIN_BATCH} as {accum} micro-batches")
    dev = torch.device("cuda")
    _free_cuda()
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    x_all, y_all = synthetic_fno_data(cfg, 4, seed=0)
    loader = ShardedDatasetLoader({"x": NdArraySource(x_all), "y": NdArraySource(y_all)},
                                  ONE_CARD_TRAIN_BATCH, device=dev, seed=0)
    try:
        def loss_of(forward):
            return lambda p, b: (mse_loss(forward(p, b["x"], cfg), b["y"]), {})

        def sum_sq_of(forward):
            # the squared error summed, not averaged: the same gradients
            # times the grid's 5.8M points, so the gate's relative term
            # rules and not its 1e-6 floor
            return lambda p, b: (mse_loss(forward(p, b["x"], cfg), b["y"]) * b["y"].numel(), {})

        micro = {k: v[: ONE_CARD_TRAIN_BATCH // accum] for k, v in loader.batch(0).items()}
        grads = {}
        for tag, forward in (("fused", fno_forward), ("unfused", fno_forward_unfused)):
            grads[tag] = zeros_like_tree(params)
            t0 = time.perf_counter()
            accumulate_grads(sum_sq_of(forward), params, micro, grads[tag])
            torch.cuda.synchronize()
            print(f"[train] {tag} forward + backward at micro-batch 1: "
                  f"{time.perf_counter() - t0:.3f}s; {gpu}")
        for group, leaves in grads["unfused"].items():
            for name, ref in leaves.items():
                _gate(f"train grad {group}.{name} fused vs unfused", grads["fused"][group][name], ref)
        del grads, micro
        _free_cuda()

        opt = init_opt_state(params)
        step = make_train_step(loss_of(fno_forward),
                               AdamWConfig(lr=warmup_cosine(1e-3, 10, steps)), grad_accum=accum)
        spectral_fused_cuda.launches = spectral_fused_dw_cuda.launches = 0
        times, metrics = [], []
        for i in range(steps):
            batch = loader.batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = {"fused": spectral_fused_cuda.launches, "dw": spectral_fused_dw_cuda.launches}
    finally:
        loader.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (t, m) in enumerate(zip(times, metrics)):
        print(f"[train] step {i}: loss {m['loss']:.6e} grad_norm {m['grad_norm']:.6e} "
              f"lr {m['lr']:.3e} in {t:.3f}s")
    print(f"[train] {steps} steps: mean step {np.mean(times[1:]):.3f}s after the first "
          f"({times[0]:.3f}s); max_memory_allocated {peak:.2f} GiB; {gpu}")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        raise SystemExit("[train] a loss or grad norm is not finite")
    want = {"fused": steps * cfg.n_blocks * 3 * accum, "dw": steps * cfg.n_blocks * accum}
    print(f"[train] launches over {steps} steps: fused {launches['fused']} (want {want['fused']}: "
          f"forward, remat recompute, dx), dw {launches['dw']} (want {want['dw']}); {gpu}")
    if launches != want:
        raise SystemExit("[train] the training steps did not launch the kernels as expected")
    del params, opt
    return launches


# Steps of the training CLIs (cut from 6 for the script's time): the fault
# at step 3 is restored from the step-2 checkpoint either way
CLI_STEPS = 4


def phase_train_cli(gpu: str) -> dict:
    """The training CLI on the card with an injected fault, then the serving
    CLI with --verify on its checkpoint; returns the launch counts of both."""
    import tempfile

    _free_cuda()  # the subprocesses need the memory this process has cached
    print(f"reduced: train CLI steps 6 -> {CLI_STEPS} (the script's time)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "fno",
               "--steps", str(CLI_STEPS), "--save-every", "2", "--inject-fault", "3",
               "--width", "8",
               "--n-data", "8", "--use-pallas", "--ckpt-dir", d]
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        print("\n".join("[train_cli] " + line for line in out.stdout.strip().splitlines()))
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"[train_cli] train exited {out.returncode}")
        if "failures=1 restores=1" not in out.stdout:
            raise SystemExit("[train_cli] the injected fault was not restored from a checkpoint")
        m = re.search(r"spectral kernel launches: fused (\d+), dw (\d+) over (\d+) train steps "
                      r"x (\d+) blocks x (\d+) micro-batches", out.stdout)
        if m is None:
            raise SystemExit("[train_cli] train printed no kernel launch counts")
        fused, dw, n_steps, n_blocks, accum = map(int, m.groups())
        if n_steps == 0 or fused != n_steps * n_blocks * 3 * accum or dw != n_steps * n_blocks * accum:
            raise SystemExit(f"[train_cli] launches fused {fused}, dw {dw} do not match "
                             f"{n_steps} steps x {n_blocks} blocks x {accum} micro-batches")
        serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve_pde", "--ckpt-dir", d,
                     "--scenarios", "4", "--max-batch", "2", "--rollout-steps", "2", "--verify"]
        srv = subprocess.run(serve_cmd, capture_output=True, text=True, env=env, timeout=600)
    print("\n".join("[train_cli] " + line for line in srv.stdout.strip().splitlines()))
    if srv.returncode != 0 or "verify OK" not in srv.stdout:
        print(srv.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"[train_cli] serve_pde exited {srv.returncode} without verify OK")
    m = re.search(r"spectral kernel launches: (\d+) over (\d+) forwards", srv.stdout)
    if m is None:
        raise SystemExit("[train_cli] serve_pde printed no spectral kernel launch count")
    served = _check_launches("train_cli serve", int(m.group(1)), n_blocks, int(m.group(2)), gpu)
    print(f"[train_cli] train launches fused {fused}, dw {dw} over {n_steps} steps; {gpu}")
    return {"fused": fused, "dw": dw, "serve": served}


# ---------------------------------------------------------------------------
# Phase data: the paper's data generation (data/pde/*, cloud/, launch/
# datagen.py) and online training, on the card.
# ---------------------------------------------------------------------------

# Each simulator on the card against itself on the CPU (tests/test_torch_data.py
# holds the CPU one to the JAX simulator at these gates)
DATA_SAT_ATOL = 1e-4            # two-phase saturation, which lies in [0, 0.9]
DATA_VORT_ATOL_OF_MAX = 1e-5    # Navier-Stokes vorticity, of its max|ref|
DATA_TWO_PHASE_CHECK = ((32, 16, 8), 8)   # (grid, frames)
DATA_NS_CHECK = (32, 8)                   # (n, frames)
DATA_NS_CENTER = (0.4, 0.5, 0.55)
# Timed at full size for this many frames (the script's time): Sleipner's
# scenario has 88 (fno_sleipner's nt), Navier-Stokes' 64 (fno_ns3d's)
DATA_TIMED_FRAMES = 2
# The fno-ns3d forward at full width on a cut grid (at 128^3 x 64 one
# float32 activation is 5.4 GB and a block needs several)
NS3D_CUT_GRID = (64, 64, 64, 64)
# train --online: 4 samples simulated by 2 spawned workers on the card
# while 4 steps train on them
ONLINE_ARGS = ["--n-data", "4", "--batch", "2", "--steps", "4", "--width", "8"]


def _simulators_on_card_vs_cpu(gpu: str) -> None:
    import torch

    from repro_torch.data.pde import navier_stokes as ns
    from repro_torch.data.pde import two_phase as tp

    grid, nt = DATA_TWO_PHASE_CHECK
    cfg = tp.TwoPhaseConfig(grid=grid, nt_frames=nt)
    mask = tp.random_well_mask(cfg, 2, 1)
    sat, iters, secs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        iters[dev] = []
        t = time.perf_counter()
        with torch.no_grad():
            sat[dev] = tp.simulate(mask, cfg, device=dev, cg_iters=iters[dev]).cpu()
        secs[dev] = time.perf_counter() - t
    err = float((sat["cuda"] - sat["cpu"]).abs().max())
    print(f"[data] two-phase {grid} x {nt} frames on the card vs the CPU: max|d|={err:.3e} "
          f"(atol {DATA_SAT_ATOL:g}; saturation max {float(sat['cpu'].max()):.3f}); CG "
          f"iterations a solve {min(iters['cuda'])}-{max(iters['cuda'])} on the card, "
          f"{min(iters['cpu'])}-{max(iters['cpu'])} on the CPU; {secs['cuda']:.2f} s on the "
          f"card (first call), {secs['cpu']:.2f} s on the CPU; {gpu}")
    if not err <= DATA_SAT_ATOL or not bool(torch.isfinite(sat["cuda"]).all()):
        raise SystemExit("[data] the two-phase simulator on the card disagrees with the CPU")
    n, nt = DATA_NS_CHECK
    out = {dev: ns.simulate(DATA_NS_CENTER, ns.NSConfig(n=n, nt_frames=nt), device=dev)
           for dev in ("cpu", "cuda")}
    chi_same = torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
    vort, ref = out["cuda"][1].cpu(), out["cpu"][1]
    err, scale = float((vort - ref).abs().max()), float(ref.abs().max())
    print(f"[data] Navier-Stokes n={n} x {nt} frames on the card vs the CPU: sphere mask "
          f"{'bitwise equal' if chi_same else 'DIFFERS'}, vorticity max|d|={err:.3e} "
          f"(max|ref|={scale:.3e}, atol {DATA_VORT_ATOL_OF_MAX:g} of it); {gpu}")
    if not chi_same or not err <= DATA_VORT_ATOL_OF_MAX * scale:
        raise SystemExit("[data] the Navier-Stokes simulator on the card disagrees with the CPU")


def _simulators_timed(gpu: str, served_per_scen_s: float) -> dict:
    """Each simulator at full size for DATA_TIMED_FRAMES frames on the card;
    returns the seconds a frame by name."""
    import torch

    from repro_torch.configs.fno_ns3d import CONFIG as NS3D
    from repro_torch.configs.fno_sleipner import CONFIG, ONE_CARD_GRID
    from repro_torch.data.pde import navier_stokes as ns
    from repro_torch.data.pde import two_phase as tp

    nt_scen, nt_ns = CONFIG.grid[3], NS3D.grid[3]
    print(f"reduced: two-phase simulator nt {nt_scen} -> {DATA_TIMED_FRAMES} frames (timed; "
          f"s/scenario extrapolated from s/frame)")
    print(f"reduced: Navier-Stokes simulator nt {nt_ns} -> {DATA_TIMED_FRAMES} frames (timed; "
          f"s/scenario extrapolated from s/frame)")
    frame_s = {}
    for name, grid in (("one-card grid", ONE_CARD_GRID[:3]), ("paper grid", CONFIG.grid[:3])):
        cfg = tp.TwoPhaseConfig(grid=tuple(grid), nt_frames=DATA_TIMED_FRAMES)
        mask, iters = tp.random_well_mask(cfg, 2, 0), []
        _free_cuda()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            sat = tp.simulate(mask, cfg, device="cuda", cg_iters=iters)
        torch.cuda.synchronize()
        per_frame = (time.perf_counter() - t) / DATA_TIMED_FRAMES
        frame_s[f"two-phase {name}"] = per_frame
        if not bool(torch.isfinite(sat).all()):
            raise SystemExit(f"[data] two-phase at {grid}: non-finite saturation")
        scen = per_frame * nt_scen
        print(f"[data] two-phase simulator, {name} {'x'.join(map(str, grid))}: {per_frame:.3f} "
              f"s/frame ({cfg.substeps} pressure solves a frame, CG iterations a solve "
              f"{min(iters)}-{max(iters)}, mean {sum(iters) / len(iters):.1f}), "
              f"{scen:.1f} s/scenario at {nt_scen} frames; vs the served surrogate's "
              f"{served_per_scen_s * 1e3:.1f} ms/scenario at {'x'.join(map(str, ONE_CARD_GRID))} "
              f"(phase serve): {scen / served_per_scen_s:.0f}x; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {gpu}")
        del sat
    cfg = ns.NSConfig(n=NS3D.grid[0], nt_frames=DATA_TIMED_FRAMES)
    _free_cuda()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.no_grad():
        _, vort = ns.simulate(DATA_NS_CENTER, cfg, device="cuda")
    torch.cuda.synchronize()
    per_frame = (time.perf_counter() - t) / DATA_TIMED_FRAMES
    frame_s["navier-stokes"] = per_frame
    if not bool(torch.isfinite(vort).all()):
        raise SystemExit("[data] Navier-Stokes at 128^3: non-finite vorticity")
    print(f"[data] Navier-Stokes simulator, n={cfg.n}: {per_frame:.3f} s/frame "
          f"({cfg.steps_per_frame} RK2 steps a frame), {per_frame * nt_ns:.1f} s/scenario at "
          f"{nt_ns} frames; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; {gpu}")
    return frame_s


def _ns3d_forward(gpu: str) -> int:
    """The fno-ns3d FNO at full width on NS3D_CUT_GRID, batch 1, its input a
    sphere mask repeated along t: block 0's fused kernel against its plain
    version, the served forward against the unfused one, and its launches;
    returns them."""
    import dataclasses

    import torch

    from repro_torch.configs.fno_ns3d import CONFIG as NS3D
    from repro_torch.core import dfft
    from repro_torch.core.fno import _encoder, fno_forward, fno_forward_unfused, init_params
    from repro_torch.data.pde.navier_stokes import NSConfig, sphere_mask
    from repro_torch.kernels.spectral_conv import (
        spectral_apply_fused, spectral_apply_fused_ref, spectral_fused_cuda,
    )

    cfg = dataclasses.replace(NS3D, grid=NS3D_CUT_GRID)
    print(f"reduced: fno-ns3d grid {'x'.join(map(str, NS3D.grid))} -> "
          f"{'x'.join(map(str, cfg.grid))} (one card; full width, modes {cfg.modes}, "
          f"{cfg.n_blocks} blocks), batch 1")
    dev = torch.device("cuda")
    _free_cuda()
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    chi = sphere_mask(NSConfig(n=cfg.grid[0]), torch.tensor(DATA_NS_CENTER, device=dev))
    x = chi[None, None, ..., None].expand((1, 1) + cfg.grid[:3] + (cfg.grid[3],)).contiguous()
    nx, ny, nz, nt = cfg.grid
    with torch.inference_mode():
        xf = dfft.serial_forward(_encoder(params, x, cfg), cfg.modes, truncate=False)
        w = params["blocks"]["w_spec"][0]
        got = spectral_apply_fused(xf, w, (nx, ny, nz), t_out=nt // 2 + 1)
        ms = cuda_ms(lambda: spectral_apply_fused(xf, w, (nx, ny, nz), t_out=nt // 2 + 1))
        ref = spectral_apply_fused_ref(xf, w, (nx, ny, nz), nt // 2 + 1)
        _gate(f"ns3d fused kernel, block 0 at {tuple(xf.shape)}, modes {cfg.modes}", got, ref)
        del got, ref
        plain_ms = cuda_ms(lambda: spectral_apply_fused_ref(xf, w, (nx, ny, nz), nt // 2 + 1),
                           iters=3, warmup=1)
        bound, by = _fused_bound_ms(1, cfg.width, cfg.width, (nx, ny, nz), tuple(w.shape[2:]),
                                    xf.shape[-1], nt // 2 + 1, False)
        del xf
        print(f"[data] ns3d fused kernel: {ms:.3f} ms at the block shape (its plain version "
              f"{plain_ms:.3f} ms), bound {bound:.3f} ms ({by}, {bound / ms:.0%} of it "
              f"reached); {gpu}")
        spectral_fused_cuda.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = fno_forward(params, x, cfg)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t
        launches = spectral_fused_cuda.launches
        y_ref = fno_forward_unfused(params, x, cfg)
    ok, err, scale = _close(y, y_ref, DIST_FWD_TOL)
    print(f"[data] fno-ns3d forward {fwd_s:.3f}s (first call), output {tuple(y.shape)} vs the "
          f"unfused forward max|d|={err:.3e} (max|ref|={scale:.3e}, rtol {DIST_FWD_TOL[0]:g}, "
          f"atol {DIST_FWD_TOL[1]:g}); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {gpu}")
    if not ok or not bool(torch.isfinite(y).all()):
        raise SystemExit("[data] the fno-ns3d forward disagrees with the unfused forward")
    del params, y, y_ref
    _free_cuda()
    return _check_launches("ns3d", launches, cfg.n_blocks, 1, gpu)


def _online(gpu: str) -> dict:
    """train --online on the card (2 spawned datagen workers), every
    sample complete, datagen --resume a no-op with the stats bit for bit,
    then serve_pde --verify --reference on its checkpoint; returns the
    launch counts."""
    import tempfile

    from repro_torch.data.store import ArrayStore
    from repro_torch.launch import datagen, serve_pde

    _free_cuda()  # the subprocess needs the memory this process has cached
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as d:
        ds, ck = os.path.join(d, "ds"), os.path.join(d, "ck")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "fno", "--online",
               "--out", ds, "--datagen-backend", "process", "--datagen-workers", "2",
               *ONLINE_ARGS, "--use-pallas", "--ckpt-dir", ck]
        t = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        print("\n".join("[online] " + line for line in out.stdout.strip().splitlines()))
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"[online] train --online exited {out.returncode}")
        print(f"[online] train --online ran in {time.perf_counter() - t:.1f}s; {gpu}")
        m = re.search(r"done: steps=(\d+) failures=0", out.stdout)
        stalls = re.search(r"online: .* stalls=(\d+)", out.stdout)
        if m is None or int(m.group(1)) != 4 or stalls is None:
            raise SystemExit("[online] train --online did not complete its 4 steps")
        m = re.search(r"spectral kernel launches: fused (\d+), dw (\d+) over (\d+) train steps "
                      r"x (\d+) blocks x (\d+) micro-batches", out.stdout)
        if m is None:
            raise SystemExit("[online] train printed no kernel launch counts")
        fused, dw, n_steps, n_blocks, accum = map(int, m.groups())
        if n_steps != 4 or fused != n_steps * n_blocks * 3 * accum or dw != n_steps * n_blocks * accum:
            raise SystemExit(f"[online] launches fused {fused}, dw {dw} do not match "
                             f"{n_steps} steps x {n_blocks} blocks x {accum} micro-batches")
        print(f"[online] stalls {stalls.group(1)}; launches fused {fused}, dw {dw} over "
              f"{n_steps} steps x {n_blocks} blocks; {gpu}")
        metas = {}
        for name in ("x", "y"):
            store = ArrayStore.open(os.path.join(ds, name))
            done = [i for i in range(store.shape[0]) if store.sample_complete(i)]
            rest = tuple(slice(0, k) for k in store.shape[1:])
            finite = all(np.isfinite(store.read_slice((slice(i, i + 1),) + rest)).all()
                         for i in done)
            if len(done) != store.shape[0] or not finite:
                raise SystemExit(f"[online] store {name}: {len(done)}/{store.shape[0]} samples "
                                 f"complete (finite: {finite})")
            with open(os.path.join(ds, name, "meta.json")) as f:
                metas[name] = f.read()
        print(f"[online] every sample of x and y complete and finite ({store.shape[0]} of "
              f"{store.shape[1:]})")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            datagen.main(["--pde", "two_phase", "--n", "4", "--grid", "16", "16", "8",
                          "--nt", "8", "--out", ds, "--resume"])
        print("\n".join("[online] " + line for line in buf.getvalue().strip().splitlines()))
        for name in ("x", "y"):
            with open(os.path.join(ds, name, "meta.json")) as f:
                if f.read() != metas[name]:
                    raise SystemExit(f"[online] datagen --resume changed {name}'s meta.json")
        if "simulating 0 (two_phase)" not in buf.getvalue():
            raise SystemExit("[online] datagen --resume simulated samples")
        print("[online] datagen --resume simulated 0 samples; the stats are bit for bit the same")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_pde.main(["--ckpt-dir", ck, "--scenarios", "4", "--verify", "--reference"])
    print("\n".join("[online] " + line for line in buf.getvalue().strip().splitlines()))
    text = buf.getvalue()
    if "verify OK" not in text or "reference simulator:" not in text:
        raise SystemExit("[online] serve_pde --verify --reference printed no verify OK or no "
                         "reference line")
    m = re.search(r"spectral kernel launches: (\d+) over (\d+) forwards", text)
    if m is None:
        raise SystemExit("[online] serve_pde printed no spectral kernel launch count")
    served = _check_launches("online serve", int(m.group(1)), n_blocks, int(m.group(2)), gpu)
    return {"fused": fused, "dw": dw, "serve": served}


def phase_data(gpu: str, served_per_scen_s: float) -> dict:
    """The simulators on the card against the CPU and timed at full size,
    the fno-ns3d forward, and online training end to end; returns the
    launch counts of the paths with kernels."""
    _free_cuda()
    t = time.perf_counter()
    _simulators_on_card_vs_cpu(gpu)
    print(f"[data] simulators held in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    frame_s = _simulators_timed(gpu, served_per_scen_s)
    print(f"[data] simulators timed in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    ns3d = _ns3d_forward(gpu)
    print(f"[data] fno-ns3d forward checked in {time.perf_counter() - t:.1f}s")
    return {"ns3d_forward": ns3d, "online": _online(gpu), "frame_s": frame_s}


# ---------------------------------------------------------------------------
# Phase dist: the domain-decomposed FNO, 1-D (P = 4) and 2-D pencils
# (PX = PY = 2), 4 gloo ranks on one card.
# ---------------------------------------------------------------------------

DIST_RANKS = 4
DIST_PENCILS = (2, 2)  # --model-shards PX PY of the 2-D runs
DIST_SERVE_BATCH, DIST_TRAIN_BATCH = 2, 1
DIST_SEED = 11
DIST_TIMEOUT_S = 600
DIST_FWD_TOL = (1e-4, 1e-5)    # rtol, atol: the reference's gate for the forwards
DIST_CHUNK_TOL = (1e-6, 1e-7)  # comm_chunks=2 vs unchunked
DIST_GRAD_TOL = (5e-3, 5e-5)   # tests/distributed_checks.py:86-91
# The reference's loss is a mean over 32,768 outputs, this one's over 5.8M,
# so its gradients are ~100x smaller than there and an atol of 5e-5 would
# pass anything. Each atol is at most this share of its scale: a
# replicated leaf's max|ref|, and for w_spec each kept mode's max|ref| over
# (ci, co), as the mean's DC mode is ~1e3x the others and would swamp a
# per-leaf scale.
DIST_GRAD_LEAF_ATOL = 1e-3
# (tag, variant, comm_chunks) of the forwards run at the training grid:
# 1-D over P = 4, then 2-D over the pencils
DIST_TRAIN_FORWARDS = (("dist_paper_train", "paper", 1), ("dist_eager", "eager", 1),
                       ("dist_grady31", "grady31", 1), ("dist_paper_chunks2", "paper", 2))
DIST2D_TRAIN_FORWARDS = (("dist2d_paper_train", "paper", 1), ("dist2d_eager", "eager", 1),
                         ("dist2d_paper_chunks2", "paper", 2))
# Grady-31's forward runs at this depth, to keep the script's time: it
# moves the spectrum untruncated, 9.7-16.6 s a forward at 4 blocks
DIST_GRADY31_BLOCKS = 1
# The training grid's other forwards and the backward run at this depth, to
# keep the script's time (a gate reads the reference a 3.15 GB block at a
# time on every rank); dist_train gates training at 2 blocks
DIST_GRID_BLOCKS = 1
# The deep-split ensemble served over the pencils: 2 scenarios sharing one
# geomodel in bucket 2, 1 rollout step (cut from 2 for the script's time),
# a cold and a warm pass, at the training grid (a cold tick's numpy
# spectral prefix runs on rank 0's host)
DIST_ENSEMBLE_BATCH, DIST_ENSEMBLE_STEPS = 2, 1


def _dist_input(cfg, batch: int, seed: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, cfg.in_channels) + cfg.grid, device=device, generator=gen)


def _dist_params(cfg, seed: int, device):
    import torch

    from repro_torch.core.fno import init_params

    return init_params(cfg, generator=torch.Generator(device=device).manual_seed(seed), device=device)


def _close(got, ref, tol) -> tuple:
    """(passed, max|d|, max|ref|) of the elementwise gate |d| <= atol + rtol |ref|."""
    rtol, atol = tol
    d = (got - ref).abs()
    passed = bool((d <= atol + rtol * ref.abs()).all())
    return passed, float(d.max()), float(ref.abs().max())


def _dist_kernel_times(gpu: str) -> dict:
    """The fused kernel (forward, dx, and forward with its ``add`` as the
    deep split's block 0 runs it) and the dW kernel at every shard shape
    the dist paths give them: the 1-D schedules' (P = 4), the 2-D pencils'
    (2 x 2) and each of ``DIST_TRAIN_RUNS``' shards at its micro-batch, in
    this process alone: each held to its plain version, two launches
    bitwise equal, timed beside its bound."""
    import torch

    from repro_torch.kernels.spectral_conv import (
        pad_kept_ref, spectral_apply_fused, spectral_apply_fused_add, spectral_apply_fused_ref,
        spectral_fused_dw, spectral_fused_dw_ref, spectral_fused_dx,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    records = {}
    for tag, cfg, b in (("serve", _serving_cfg(), DIST_SERVE_BATCH),
                        ("train", _train_cfg(), DIST_TRAIN_BATCH)):
        nx, ny, nz, nt = cfg.grid
        k1, k2, k3, kt = cfg.mode_shape
        ci = co = cfg.width

        def spectrum(c, ext, t, b):
            z = torch.randn((b, c) + ext + (t,), dtype=torch.complex64, device=dev, generator=gen)
            return torch.fft.fft(z, dim=2)  # the layout the block's x FFT leaves

        def kept_of(shards):  # a model shard's kept modes: k_y over P or PX, k_z over PY
            return (k1, k2 // shards[0], k3 // (shards[1] if len(shards) == 2 else 1), kt)

        # (label, batch, kept modes) of each layout's shard; the train runs'
        # batch is a data rank's micro-batch
        layouts = [("paper", b, kept_of((DIST_RANKS,))), ("pencil", b, kept_of(DIST_PENCILS))]
        if tag == "train":
            for run, shards, _, batch, accum, _ in DIST_TRAIN_RUNS:
                mb = batch // (DIST_RANKS // int(np.prod(shards))) // accum
                if (mb, kept_of(shards)) not in {(bb, kk) for _, bb, kk in layouts}:
                    layouts.append((f"{run} P={'x'.join(map(str, shards))}", mb, kept_of(shards)))
        # (name, op, trunc, x extents, x time bins, t_out, kept, batch): the
        # served grid runs forwards only, the training grid forward, dx and dW
        cases = []
        for label, bb, kept in layouts:
            ext = (nx, kept[1], kept[2])
            ops = ("forward",) if tag == "serve" else ("forward", "dx", "dW")
            cases += [(f"{tag} {label} shard {op}", op, (nx, None, None), ext, kt, None, kept, bb)
                      for op in ops]
        if tag == "serve":
            kept1 = kept_of((DIST_RANKS,))
            cases.insert(1, (f"{tag} grady31 shard forward", "forward", (nx, None, nz),
                             (nx, kept1[1], nz), nt // 2 + 1, nt // 2 + 1, kept1, b))
        else:  # block 0 of the deep split, at the ensemble's bucket
            cases += [(f"{tag} {label} shard forward add", "add", (nx, None, None),
                       (nx, kept[1], kept[2]), kt, None, kept, DIST_ENSEMBLE_BATCH)
                      for label, kept in (("paper", kept_of((DIST_RANKS,))),
                                          ("pencil", kept_of(DIST_PENCILS)))]
        for name, op, trunc, ext, t_x, t_out, kept, b in cases:
            w = torch.randn((ci, co) + kept, dtype=torch.complex64, device=dev, generator=gen)
            t_y = kt if t_out is None else t_out
            if op == "forward":
                xf = spectrum(ci, ext, t_x, b)
                run = lambda: spectral_apply_fused(xf, w, trunc, t_out=t_out)
                plain = lambda: spectral_apply_fused_ref(xf, w, trunc, t_out)
                bound = _fused_bound_ms(b, ci, co, ext, kept, t_x, t_y, False)
            elif op == "add":
                xf = spectrum(ci, ext, t_x, b)
                add = torch.randn((b, co) + kept, dtype=torch.complex64, device=dev, generator=gen)
                run = lambda: spectral_apply_fused_add(xf, w, add, trunc, t_out=t_out)
                plain = lambda: (spectral_apply_fused_ref(xf, w, trunc, t_out)
                                 + pad_kept_ref(add, trunc, t_out))
                bound = _fused_bound_ms(b, ci, co, ext, kept, t_x, t_y, True)
            elif op == "dx":
                g = spectrum(co, ext, t_y, b)
                wt = w.transpose(0, 1).conj()
                run = lambda: spectral_fused_dx(g, w, trunc, t_x)
                plain = lambda: spectral_apply_fused_ref(g, wt, trunc, t_x)
                bound = _fused_bound_ms(b, co, ci, ext, kept, t_y, t_x, False)
            else:
                xf, g = spectrum(ci, ext, t_x, b), spectrum(co, ext, t_y, b)
                run = lambda: spectral_fused_dw(xf, g, trunc, kept)
                plain = lambda: spectral_fused_dw_ref(xf, g, trunc, kept)
                bound = _dw_bound_ms(b, ci, co, kept)
            got = run()
            if not torch.equal(got, run()):
                raise SystemExit(f"[dist kernel] {name}: two launches on the same inputs differ")
            err = _gate(f"dist kernel {name}", got, plain())
            del got
            torch.cuda.empty_cache()
            ms, plain_ms = cuda_ms(run), cuda_ms(plain, iters=5)
            records[name] = {"b": b, "trunc": list(trunc), "x_extents": list(ext), "kept": list(kept),
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                             "bound_by": bound[1], "max_abs_err": err}
            print(f"[dist kernel] {name}: b={b} E={ext} K={kept} trunc {trunc}: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}); {gpu}")
            xf = g = wt = w = add = run = plain = None
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return records


def _block_split(local, x_local, cfg, group) -> dict:
    """CUDA-event times of one paper block's parts on this rank, the other
    ranks running the same at once: the forward transform (FFTs and the
    all-to-all), the all-to-all alone on a tensor of the shape it moves,
    the fused kernel, the inverse transform and its all-to-all."""
    import torch

    from repro_torch.core import collectives, dfft
    from repro_torch.core.repartition import repartition
    from repro_torch.kernels.spectral_conv import spectral_apply_fused
    from repro_torch.launch.comm_analysis import wire_line

    nx = cfg.grid[0]
    w = local["blocks"]["w_spec"][0]
    ms = {}
    with torch.inference_mode():
        h = torch.randn((x_local.shape[0], cfg.width) + tuple(x_local.shape[2:]),
                        device=x_local.device)
        ms["forward transform"] = cuda_ms(
            lambda: dfft.dist_forward(h, cfg.modes, group, trunc_x=False), iters=3, warmup=1)
        xf = dfft.dist_forward(h, cfg.modes, group, trunc_x=False)
        pre = repartition(xf, dfft.YDIM, dfft.XDIM, group)  # what R_{x->y} takes
        ms["all_to_all x->y"] = cuda_ms(
            lambda: repartition(pre, dfft.XDIM, dfft.YDIM, group), iters=3, warmup=1)
        ms["fused kernel"] = cuda_ms(lambda: spectral_apply_fused(xf, w, (nx, None, None)),
                                     iters=3, warmup=1)
        yf = spectral_apply_fused(xf, w, (nx, None, None))
        ms["inverse transform"] = cuda_ms(
            lambda: dfft.dist_adjoint(yf, cfg.grid, group, pad_x=False), iters=3, warmup=1)
        ms["all_to_all y->x"] = cuda_ms(
            lambda: repartition(yf, dfft.YDIM, dfft.XDIM, group), iters=3, warmup=1)
    ms["FFTs, truncation and padding"] = (ms["forward transform"] + ms["inverse transform"]
                                         - ms["all_to_all x->y"] - ms["all_to_all y->x"])
    with torch.inference_mode(), collectives.timed(sync=False) as count:
        repartition(pre, dfft.XDIM, dfft.YDIM, group)
        repartition(yf, dfft.YDIM, dfft.XDIM, group)
    return ms, wire_line(count["ops"])


def _block_split_2d(local, x_local, cfg, pair) -> dict:
    """CUDA-event times of one 2-D paper block's parts on this rank, the
    other ranks running the same at once: the forward transform (FFTs and
    the two all-to-alls), each all-to-all alone on a tensor of the shape it
    moves, the fused kernel and the inverse transform."""
    import torch

    from repro_torch.core import collectives, dfft
    from repro_torch.core.repartition import repartition
    from repro_torch.kernels.spectral_conv import spectral_apply_fused
    from repro_torch.launch.comm_analysis import wire_line

    g_x, g_y = pair
    nx, mz, mt = cfg.grid[0], cfg.modes[2], cfg.modes[3]
    w = local["blocks"]["w_spec"][0]
    ms = {}
    with torch.inference_mode():
        h = torch.randn((x_local.shape[0], cfg.width) + tuple(x_local.shape[2:]),
                        device=x_local.device)
        ms["forward transform"] = cuda_ms(
            lambda: dfft.dist_forward_2d(h, cfg.modes, pair, trunc_x=False), iters=3, warmup=1)
        # what R^{my}_{y->z} and R^{mx}_{x->y} take: the local z/t-truncated
        # pencil, and the y-truncated one after the first move
        zt = torch.zeros(tuple(h.shape[:4]) + (2 * mz, mt), dtype=torch.complex64, device=h.device)
        ms["all_to_all y->z (my)"] = cuda_ms(
            lambda: repartition(zt, dfft.YDIM, dfft.ZDIM, g_y), iters=3, warmup=1)
        yz = dfft.truncate_full(repartition(zt, dfft.YDIM, dfft.ZDIM, g_y), dfft.YDIM, cfg.modes[1])
        ms["all_to_all x->y (mx)"] = cuda_ms(
            lambda: repartition(yz, dfft.XDIM, dfft.YDIM, g_x), iters=3, warmup=1)
        xf = dfft.dist_forward_2d(h, cfg.modes, pair, trunc_x=False)
        ms["fused kernel"] = cuda_ms(lambda: spectral_apply_fused(xf, w, (nx, None, None)),
                                     iters=3, warmup=1)
        yf = spectral_apply_fused(xf, w, (nx, None, None))
        ms["inverse transform"] = cuda_ms(
            lambda: dfft.dist_adjoint_2d(yf, cfg.grid, pair, pad_x=False), iters=3, warmup=1)
    ms["FFTs, truncation and padding"] = (ms["forward transform"] + ms["inverse transform"]
                                         - 2 * ms["all_to_all y->z (my)"]
                                         - 2 * ms["all_to_all x->y (mx)"])
    with torch.inference_mode(), collectives.timed(sync=False) as count:
        dfft.dist_adjoint_2d(dfft.dist_forward_2d(h, cfg.modes, pair, trunc_x=False), cfg.grid,
                             pair, pad_x=False)
    return ms, wire_line(count["ops"])


def _dist_setup(world_size: int, device) -> tuple:
    """A rank's start: the parent's float32 settings, the kernel library the
    parent built (found up to date, never compiled here) and the groups of
    the two layouts, by the names their partitions use: "1d" (one model
    group of every rank) and "2d" (the 2 x 2 pencils)."""
    import torch

    from repro_torch.core.fno import group_names
    from repro_torch.kernels.spectral_conv import build
    from repro_torch.launch.mesh import build_fno_groups

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load_library()
    load_s = time.perf_counter() - t0
    layouts = {}
    for name, shards in (("1d", [world_size]), ("2d", list(DIST_PENCILS))):
        data_group, model, _ = build_fno_groups(world_size, shards)
        layouts[name] = (model, group_names(data_group, model))
    return load_s, layouts


def _dist_local_params(cfg, seed: int, model, device) -> dict:
    """This rank's shard of the seeded weights under one layout. The ranks
    generate the full weights in turn, so that one 12.6 GB copy exists at
    a time."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.fno import shard_params

    local = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            local = shard_params(_dist_params(cfg, seed, device), model)
            torch.cuda.empty_cache()
        dist.barrier()
    return local


def _dist_local(cfg, batch: int, seed: int, model, groups: dict, device) -> tuple:
    """This rank's shard of the seeded weights and input under one layout."""
    from repro_torch.core.fno import input_spec, model_axes
    from repro_torch.core.partition import shard

    local = _dist_local_params(cfg, seed, model, device)
    x = _dist_input(cfg, batch, seed, device)
    return local, shard(x, input_spec("data", model_axes(model)), groups)


def _counted(fn) -> tuple:
    """fn()'s result and its wall time and kernel launches, counted from 0."""
    import torch

    from repro_torch.kernels.spectral_conv import spectral_fused_cuda, spectral_fused_dw_cuda

    spectral_fused_cuda.launches = spectral_fused_dw_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    y = fn()
    torch.cuda.synchronize()
    return y, {"s": time.perf_counter() - t, "fused": spectral_fused_cuda.launches,
               "dw": spectral_fused_dw_cuda.launches}


def _serve_on_ranks(runner, requests, passes: int = 1):
    """Rank 0 serves ``requests()`` (fresh ones each pass) through the
    scheduler and closes the runner; the other ranks follow its ticks.
    Returns rank 0's served requests of each pass, by rid (None elsewhere)."""
    from repro_torch.launch.serve_pde import check_served, serve

    if not runner.is_controller:
        runner.follow()
        return None
    out = []
    for _ in range(passes):
        reqs = requests()
        done, _, sched = serve(runner, reqs, runner.max_slots, SCHED_MAX_STEPS)
        check_served(done, reqs, sched.failed)
        out.append(sorted(done, key=lambda r: r.rid))
    runner.close()
    return out


def _dist_serve_part(layouts: dict, job: dict, device) -> dict:
    """The served grid on this rank: ``FNORunner`` ticks over the 1-D and
    the 2-D layout at full width (bucket 2: 2 scenarios, 1 rollout step),
    each tick's split, each rank's peak memory and one paper block's
    split. Rank 0 returns the served outputs."""
    import torch

    from repro_torch.serve import FNORunner, ScenarioRequest

    cfg = _serving_cfg()
    out = {"split": {}}
    x = _dist_input(cfg, DIST_SERVE_BATCH, job["seed"], device).cpu().numpy()
    for name, tag in (("1d", "dist_paper"), ("2d", "dist2d_paper")):
        model, groups = layouts[name]
        local, x_local = _dist_local(cfg, DIST_SERVE_BATCH, job["seed"], model, groups, device)
        runner = FNORunner(cfg, local, device=device, data_group=groups["data"], model=model,
                           max_slots=DIST_SERVE_BATCH, buckets=(DIST_SERVE_BATCH,))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        served, out[tag] = _counted(lambda: _serve_on_ranks(runner, lambda: [
            ScenarioRequest(rid=i, x=x[i], steps=1) for i in range(DIST_SERVE_BATCH)]))
        out[tag]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[tag]["ticks"] = list(runner.tick_times)
        if served is not None:
            out[tag]["y"] = torch.from_numpy(np.stack([r.outputs[0] for r in served[0]]))
        del runner
        torch.cuda.empty_cache()
        if name == "1d":  # for phase dryrun: the bytes of this rank's shards
            out[tag]["param_bytes"] = sum(t.numel() * t.element_size() for t in _leaves(local))
        split = _block_split if name == "1d" else _block_split_2d
        out["split"][name], out.setdefault("split_wire", {})[name] = split(local, x_local, cfg,
                                                                            model)
        del local, x_local
        torch.cuda.empty_cache()
    return out


def _ensemble_cfg():
    import dataclasses

    return dataclasses.replace(_train_cfg(), in_channels=2)


def _ensemble_requests(cfg):
    from repro_torch.launch.serve_pde import build_scenarios

    return build_scenarios(cfg, DIST_ENSEMBLE_BATCH, 2, seed=0, steps=DIST_ENSEMBLE_STEPS,
                           n_static=1)[0]


def _dist_ensemble_part(layouts: dict, job: dict, device) -> dict:
    """The deep-split ensemble over the 2-D pencils at full width on the
    training grid: ``FNORunner`` with the geomodel cache (rank 0's), a cold
    and a warm pass of ``DIST_ENSEMBLE_BATCH`` scenarios sharing one
    geomodel. Rank 0 returns both passes' outputs and the cache's stats."""
    import torch

    from repro_torch.serve import FNORunner

    cfg = _ensemble_cfg()
    model, groups = layouts["2d"]
    local = _dist_local_params(cfg, job["seed"] + 2, model, device)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    runner = FNORunner(cfg, local, device=device, data_group=groups["data"], model=model,
                       max_slots=DIST_ENSEMBLE_BATCH, buckets=(DIST_ENSEMBLE_BATCH,), n_static=1,
                       cache_level="deep", cache_bytes=16 << 30)
    made_s = time.perf_counter() - t
    passes, out = _counted(lambda: _serve_on_ranks(runner, lambda: _ensemble_requests(cfg), 2))
    out.update(made_s=made_s, ticks=list(runner.tick_times))
    if passes is not None:
        out["outputs"] = [{r.rid: [torch.from_numpy(y) for y in r.outputs] for r in done}
                          for done in passes]
        out["cache"] = {k: runner.cache.stats[k] for k in ("hits", "misses", "hit_rate")}
    del runner, local
    torch.cuda.empty_cache()
    return out


# The ranked fleet: two replicas over 1 x 4 at the training grid, one tick
# of bucket 2 each (two geomodels, the prelift level's split forward)
DIST_FLEET_BATCH = 2


def _dist_fleet_part(layouts: dict, job: dict, device) -> dict:
    """Two ranked replicas over the 1-D layout (1 x 4) at full width on the
    training grid, built alike on every rank and linked to share this one
    start of the ranks, behind the gateway (affinity routing): two
    geomodels, one tick of bucket 2 on each replica, at the prelift level.
    Rank 0 returns the outputs by rid and the routing; every rank its ticks
    on each replica."""
    import torch

    from repro_torch.launch.serve_pde import check_served
    from repro_torch.serve import FNORunner, Gateway, link_replicas

    cfg = _ensemble_cfg()
    model, groups = layouts["1d"]
    local = _dist_local_params(cfg, job["seed"] + 2, model, device)
    twin = {g: {k: t.clone() for k, t in leaves.items()} for g, leaves in local.items()}
    torch.cuda.empty_cache()
    t = time.perf_counter()
    runners = [FNORunner(cfg, p, device=device, data_group=groups["data"], model=model,
                         max_slots=DIST_FLEET_BATCH, buckets=(DIST_FLEET_BATCH,), n_static=1,
                         cache_level="prelift") for p in (local, twin)]
    link_replicas(runners)
    made_s = time.perf_counter() - t
    del local, twin

    def serve_fleet():
        if not runners[0].is_controller:
            runners[0].follow()
            return None
        gw = Gateway(runners, policy="affinity")
        reqs = _fleet_requests(_fleet_inputs(cfg, 2 * DIST_FLEET_BATCH))
        for r in reqs:
            gw.submit(r)
        done = gw.run_until_done(max_steps=SCHED_MAX_STEPS)
        runners[0].close()
        check_served(done, reqs, gw.failed)
        return {"y": {r.rid: torch.from_numpy(r.outputs[0]) for r in done},
                "routed": [h.routed for h in gw.replicas]}

    served, out = _counted(serve_fleet)
    out.update(made_s=made_s, ticks=[list(r.tick_times) for r in runners])
    if served is not None:
        out.update(served)
    del runners
    torch.cuda.empty_cache()
    return out


def _check_dist_fleet(ranks, params, gpu: str) -> None:
    """The ranked fleet of ``_dist_fleet_part``: a geomodel on each replica,
    every rank one tick on each, rank 0's outputs against the serial fused
    forward on the same inputs (``params``: the seeded weights on the card)
    at the dist gate."""
    import torch

    from repro_torch.core.fno import fno_forward

    cfg = _ensemble_cfg()
    fleet = ranks[0]["fleet"]
    if fleet["routed"] != [DIST_FLEET_BATCH] * 2:
        raise SystemExit(f"[dist_fleet] routed {fleet['routed']}: the two geomodels were not "
                         f"pinned to different replicas")
    for r, res in enumerate(ranks):
        ticks = [len(t) for t in res["fleet"]["ticks"]]
        if ticks != [1, 1]:
            raise SystemExit(f"[dist_fleet] rank {r} ran {ticks} ticks on the replicas, not one "
                             f"each")
        print(f"[dist_fleet] rank {r}: replicas made in {res['fleet']['made_s']:.2f}s, served in "
              f"{res['fleet']['s']:.3f}s; ticks: " + "; ".join(
                  ", ".join(f"{k} {v:.3f}s" for k, v in t[0].items())
                  for t in res["fleet"]["ticks"]) + f"; {gpu}")
    for rid, x in enumerate(_fleet_inputs(cfg, 2 * DIST_FLEET_BATCH)):
        with torch.inference_mode():
            ref = fno_forward(params, torch.from_numpy(x[None]).cuda(), cfg)[0].cpu()
        ok, err, scale = _close(fleet["y"][rid], ref, DIST_FWD_TOL)
        print(f"[dist_fleet] rid {rid} (replica r{rid % 2}) vs the serial fused forward: "
              f"max|d|={err:.3e} (max|ref|={scale:.3e}, rtol {DIST_FWD_TOL[0]:g}, atol "
              f"{DIST_FWD_TOL[1]:g}); {gpu}")
        if not ok:
            raise SystemExit(f"[dist_fleet] rid {rid}: outside the gate")


def _model_names(groups: dict) -> list:
    return [n for n in groups if n != "data"]


def _narrowed(ref, part, groups: dict, shape, shift_dim=None):
    """``ref``, a global tensor, cut along every dim ``part`` shards to
    this rank's run of length ``shape[dim]`` (along ``shift_dim``, to the
    run of the next rank of that dim's group)."""
    import torch.distributed as dist

    for dim, name in enumerate(part.dims):
        if name is not None:
            me, n, k = dist.get_rank(groups[name]), dist.get_world_size(groups[name]), shape[dim]
            ref = ref.narrow(dim, ((me + 1) % n if dim == shift_dim else me) * k, k)
    return ref


def _gate_leaf(g, ref, part, groups, tol, scale) -> dict:
    """One leaf of this rank against the matching slice of the global
    reference. A replicated leaf (``ref`` a tensor on the card) whole, at
    atol min(tol's, LEAF_ATOL * scale); a sharded, stacked ``w_spec``
    block by block (``ref(i)``: the global block i on the card), each kept
    mode at atol min(tol's, LEAF_ATOL * its max|ref| over (ci, co)). The
    same gate must refuse zeros and, for ``w_spec``, ci/co swapped and the
    neighbouring shard along every sharded dim (the next rank of that
    dim's group)."""
    import torch

    from repro_torch.core.partition import CartPartition

    rtol, atol = tol
    results = {}  # what -> [(passed, max|d|, max|ref|)], one per block

    def gate(what, got, want, t):
        results.setdefault(what, []).append(_close(got, want, (rtol, t)))

    if part is None:
        t = min(atol, DIST_GRAD_LEAF_ATOL * scale)
        gate("value", g, ref, t)
        gate("zeros", torch.zeros_like(g), ref, t)
        atols = (t, t)
    else:
        block_part, lo, hi = CartPartition(part.dims[1:]), [], []
        for i in range(g.shape[0]):
            full = ref(i)
            want = _narrowed(full, block_part, groups, g.shape[1:])
            t = (DIST_GRAD_LEAF_ATOL * want.abs().amax(dim=(0, 1), keepdim=True)).clamp(max=atol)
            lo.append(float(t.min()))
            hi.append(float(t.max()))
            gate("value", g[i], want, t)
            gate("ci/co swapped", g[i].transpose(0, 1), want, t)
            gate("zeros", torch.zeros((), dtype=g.dtype, device=g.device).expand_as(g[i]), want, t)
            for dim, name in enumerate(block_part.dims):
                if name is not None:
                    gate(f"neighbouring shard along dim {dim + 1}",
                         _narrowed(full, block_part, groups, g.shape[1:], dim), want, t)
            del full, want, t
        atols = (min(lo), max(hi))
    value = results.pop("value")
    return {"ok": all(c[0] for c in value), "max_d": max(c[1] for c in value), "max_ref": scale,
            "atol": atols,
            "passed_wrong": [what for what, cs in results.items() if all(c[0] for c in cs)]}


def _dist_grad_check(fwd, local, x_local, groups, part_w, job, cfg) -> tuple:
    """One forward + backward of the mean squared output on this rank's
    shards; every leaf's global gradient held against the serial one
    (``job["grad_ref"]``: the replicated leaves on the host, ``w_spec`` in
    the file ``job["grad_w_spec_path"]``, read a block at a time) by
    ``_gate_leaf``. Returns (launch record, gate results)."""
    import torch
    import torch.distributed as dist

    from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree

    n_out = DIST_TRAIN_BATCH * cfg.out_channels * int(np.prod(cfg.grid))
    grads = zeros_like_tree(local)
    _, run = _counted(lambda: accumulate_grads(
        lambda prm, b: (fwd(prm, b["x"]).square().sum() / n_out, {}), local, {"x": x_local}, grads))
    checked, w_ref = {}, np.load(job["grad_w_spec_path"], mmap_mode="r")
    for group_name, leaves in grads.items():
        for name, g in leaves.items():
            if name == "w_spec":
                part = part_w
                ref = lambda i: torch.from_numpy(np.array(w_ref[i])).to(g.device)
            else:  # replicated: the model groups' shares summed
                part, ref = None, job["grad_ref"][group_name][name].to(g.device)
                for n in _model_names(groups):
                    dist.all_reduce(g, group=groups[n])
            checked[f"{group_name}.{name}"] = _gate_leaf(
                g, ref, part, groups, DIST_GRAD_TOL, job["grad_max"][f"{group_name}.{name}"])
    return run, checked


def _first_blocks(params: dict, n: int) -> dict:
    """``params`` cut to its first ``n`` FNO blocks (views)."""
    return {**params, "blocks": {k: v[:n] for k, v in params["blocks"].items()}}


def _dist_train_grid_part(layouts: dict, job: dict, device) -> dict:
    """The training grid on this rank: the 1-D eager, Grady-31 (at
    ``DIST_GRADY31_BLOCKS`` blocks) and chunked forwards and the 2-D
    paper, eager and chunked ones, and one paper forward + backward of
    each layout whose gradient this rank holds against the serial one
    (``job["grad_ref"]``)."""
    import dataclasses

    import torch

    from repro_torch.core.fno import make_dist_forward, param_partitions

    cfg = _dist_train_cfg(DIST_GRID_BLOCKS)
    out = {"grads": {}}
    for name, forwards, back in (("1d", DIST_TRAIN_FORWARDS, "dist_backward"),
                                 ("2d", DIST2D_TRAIN_FORWARDS, "dist2d_backward")):
        model, groups = layouts[name]
        local, x_local = _dist_local(cfg, DIST_TRAIN_BATCH, job["seed"] + 1, model, groups, device)
        for tag, variant, chunks in forwards:
            blocks = DIST_GRADY31_BLOCKS if variant == "grady31" else cfg.n_blocks
            fwd = make_dist_forward(dataclasses.replace(cfg, comm_chunks=chunks, n_blocks=blocks),
                                    model, variant=variant)
            with torch.inference_mode():
                y, out[tag] = _counted(lambda: fwd(_first_blocks(local, blocks), x_local))
            out[tag]["y"] = y.cpu()
        fwd = make_dist_forward(cfg, model, variant="paper")
        part_w = param_partitions(model)["blocks"]["w_spec"]
        out[back], out["grads"][name] = _dist_grad_check(fwd, local, x_local, groups, part_w,
                                                         job, cfg)
        del local, x_local
        torch.cuda.empty_cache()
    return out


# The GPipe baseline (core/pipeline.py) in the same launch: the 1-D
# layout's model group as the (1 x 4) stage group, 4 blocks = 4 stages at
# full width on the training grid, batch 2 as 2 micro-batches; and top-k
# compression with error feedback over the 4 ranks as one data group, on a
# 64 MiB float32 leaf and a 64 MiB complex64 leaf per rank.
PIPE_SEED = DIST_SEED + 5
PIPE_BATCH, PIPE_MICRO = 2, 2
COMP_LEAF_BYTES = 64 << 20
COMP_RATIOS = (1.0, 0.01)
COMP_DENSE_TOL = (1e-5, 1e-6)     # ratio 1.0 vs the dense mean
COMP_CONSERVE_TOL = (1e-4, 1e-5)  # reduced + mean residual vs the dense mean


def _pipeline_cfg():
    return _dist_train_cfg(DIST_RANKS)


def _pipeline_grad_gate(g, want, scale: float, wrongs=()) -> dict:
    """``_gate_leaf``'s rule for one pipeline stage's leaf: rtol of
    DIST_GRAD_TOL, atol at most DIST_GRAD_LEAF_ATOL of the scale (for
    w_spec [1, ci, co, kx, ky, kz, kt], of each kept mode's max|ref| over
    (ci, co), and compared a slice of ci at a time: a stage's block is
    3.15 GB). The same gate must refuse zeros, the gradient taken P times
    (every rank's copy of the loss's cotangent summed) and each of
    ``wrongs``: (name, fn), fn(ci slice) the wrong gradient's slice."""
    import torch

    rtol, atol = DIST_GRAD_TOL
    if g.is_complex():
        parts = [slice(i, i + 8) for i in range(0, g.shape[1], 8)]
        m = torch.stack([want[:, sl].abs().amax(dim=(1, 2), keepdim=True) for sl in parts])
        t = (DIST_GRAD_LEAF_ATOL * m.amax(dim=0)).clamp(max=atol)
    else:
        parts = [None]
        t = torch.tensor(min(atol, DIST_GRAD_LEAF_ATOL * scale), device=g.device)

    def part(x, sl):
        return x if sl is None else x[:, sl]

    def passes(fn) -> tuple:
        res = [_close(fn(sl), part(want, sl), (rtol, t)) for sl in parts]
        return all(r[0] for r in res), max(r[1] for r in res)

    ok, max_d = passes(lambda sl: part(g, sl))
    wrongs = (("zeros", lambda sl: torch.zeros_like(part(g, sl))),
              (f"{DIST_RANKS} times", lambda sl: DIST_RANKS * part(g, sl))) + tuple(wrongs)
    return {"ok": ok, "max_d": max_d, "max_ref": scale,
            "atol": (float(t.min()), float(t.max())),
            "passed_wrong": [name for name, fn in wrongs if passes(fn)[0]]}


def _dist_pipeline_part(layouts: dict, job: dict, device) -> dict:
    """One GPipe forward (with its trace) and backward of the mean squared
    output on this stage; every gradient leaf this stage holds is gated
    against the serial gradient (``job["pipe"]``): its own block, read from
    the file a block at a time, and the encoder and decoder once the
    replicated leaves are reduced over the stages. Rank 0 returns the
    output."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.pipeline import (
        make_pipeline_forward, reduce_pipeline_grads, shard_pipeline_params,
    )
    from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree

    cfg, pj = _pipeline_cfg(), job["pipe"]
    model, _ = layouts["1d"]
    stage = dist.get_rank(model)
    local = None
    for turn in range(dist.get_world_size()):  # one 12.6 GB copy at a time
        if turn == dist.get_rank():
            local = shard_pipeline_params(_dist_params(cfg, pj["seed"], device), model)
            torch.cuda.empty_cache()
        dist.barrier()
    x = _dist_input(cfg, PIPE_BATCH, pj["seed"], device)
    fwd = make_pipeline_forward(cfg, model, n_micro=PIPE_MICRO)
    grads, trace, y = zeros_like_tree(local), [], {}

    def loss(prm, b):
        y["y"] = fwd(prm, b["x"], trace)
        return y["y"].square().mean(), {}

    torch.cuda.reset_peak_memory_stats()
    _, rec = _counted(lambda: accumulate_grads(loss, local, {"x": x}, grads))
    out = {"dist_pipeline": dict(rec, trace=trace,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)}
    if dist.get_rank() == 0:
        out["dist_pipeline"]["y"] = y["y"].detach().cpu()
    del y
    reduce_pipeline_grads(grads, model)
    torch.cuda.empty_cache()
    checked, refs = {}, pj["grad_ref"]
    w_ref = np.load(pj["w_spec_path"], mmap_mode="r")
    for group_name, leaves in grads.items():
        for name, g in leaves.items():
            key, scale = f"{group_name}.{name}", pj["grad_max"][f"{group_name}.{name}"]
            if name == "w_spec":
                want = torch.from_numpy(np.array(w_ref[stage:stage + 1])).to(device)
                nxt = (stage + 1) % DIST_RANKS  # the gate must tell the stages' blocks apart
                checked[key] = _pipeline_grad_gate(g, want, scale, (
                    ("ci/co swapped", lambda sl: g.transpose(1, 2)[:, sl]),
                    ("the next stage's block", lambda sl: torch.from_numpy(
                        np.array(w_ref[nxt:nxt + 1, sl])).to(device))))
                del want
                continue
            want = refs[group_name][name]
            if group_name == "blocks":
                want = want[stage:stage + 1]
            checked[key] = _pipeline_grad_gate(g, want.to(device), scale)
    out["dist_pipeline"]["grads"] = checked
    del local, grads, x
    torch.cuda.empty_cache()
    return out


def _dist_compression_part(job: dict, device) -> dict:
    """``compress_leaf`` over every rank as one data group on this rank's
    seeded leaves, each ratio against the dense mean: ratio 1.0 equal to it
    with a zero residual, a smaller ratio conserving it (reduced + mean
    residual)."""
    import torch
    import torch.distributed as dist

    from repro_torch.train import compression

    group = dist.group.WORLD
    gen = torch.Generator(device=device).manual_seed(job["seed"] + 100 + dist.get_rank())
    n = COMP_LEAF_BYTES // 4
    leaves = {"float32": torch.randn(n, generator=gen, device=device),
              "complex64": torch.randn(n // 2, dtype=torch.complex64, generator=gen,
                                       device=device)}
    out = {}
    for name, g in leaves.items():
        dense = compression._mean_over(g, group)
        for ratio in COMP_RATIOS:
            (red, err), rec = _counted(lambda: compression.compress_leaf(
                g, torch.zeros_like(g), group, ratio))
            if ratio == 1.0:
                ok, max_d, _ = _close(red, dense, COMP_DENSE_TOL)
                ok = ok and not bool(err.any())
            else:
                ok, max_d, _ = _close(red + compression._mean_over(err, group), dense,
                                      COMP_CONSERVE_TOL)
            out[f"{name} ratio {ratio:g}"] = {"ok": ok, "max_d": max_d, "s": rec["s"]}
            del red, err
    return out


def _dist_rank(rank, world_size, device, job):
    """One rank of the dist phases' single launch (one start-up of the
    ranks' processes and their CUDA libraries for all of them): the served
    grid's forwards, the training grid's forwards and backwards, then the
    distributed train step of each of ``DIST_TRAIN_RUNS``."""
    import torch

    load_s, layouts = _dist_setup(world_size, device)
    out = {"load_s": load_s}
    for part, run in (("serve", lambda: _dist_serve_part(layouts, job, device)),
                      ("ensemble", lambda: _dist_ensemble_part(layouts, job, device)),
                      ("fleet", lambda: _dist_fleet_part(layouts, job, device)),
                      ("train_grid", lambda: _dist_train_grid_part(layouts, job, device)),
                      ("pipeline", lambda: _dist_pipeline_part(layouts, job, device)),
                      ("compression", lambda: {"leaves": _dist_compression_part(job, device)})):
        print(f"[dist] rank {rank} before {part}: {_memory_line()}", flush=True)
        t = time.perf_counter()
        out[part] = run()
        out[part]["wall_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    out["dist_train"] = {}
    for run in job["train_runs"]:
        t = time.perf_counter()
        out["dist_train"][run["tag"]] = _dist_train_run(rank, world_size, device, run)
        out["dist_train"][run["tag"]]["wall_s"] = time.perf_counter() - t
    return out


def _pipeline_reference(d: str) -> tuple:
    """(job, y): the serial references of the pipeline run, on the card,
    then off it: the forward's output on the host, every gradient leaf but
    w_spec on the host and w_spec's in a file under ``d`` (the batch's mean
    loss as the mean of its samples' means, one sample at a time, as the
    training phase fits the card)."""
    import torch

    from repro_torch.core.fno import fno_forward
    from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree

    cfg, dev = _pipeline_cfg(), torch.device("cuda")
    params = _dist_params(cfg, PIPE_SEED, dev)
    x = _dist_input(cfg, PIPE_BATCH, PIPE_SEED, dev)
    grads, ys = zeros_like_tree(params), []

    def loss(prm, b):
        y = fno_forward(prm, b["x"], cfg)
        ys.append(y.detach().cpu())
        return y.square().mean() / PIPE_BATCH, {}

    for i in range(PIPE_BATCH):
        accumulate_grads(loss, params, {"x": x[i:i + 1]}, grads)
    grad_max = {f"{g}.{n}": max(float(t.abs().max()) for t in v)
                for g, leaves in grads.items() for n, v in leaves.items()}
    path = os.path.join(d, "pipe_grad_w_spec.npy")
    _to_file(grads["blocks"].pop("w_spec"), path)
    grad_ref = {g: {n: v.cpu() for n, v in leaves.items()} for g, leaves in grads.items()}
    del params, x, grads
    _free_cuda()
    return ({"seed": PIPE_SEED, "grad_ref": grad_ref, "grad_max": grad_max, "w_spec_path": path},
            torch.cat(ys))


def _check_pipeline(ranks, y_ref, gpu: str) -> None:
    """The pipeline's output, gradients and per-stage times, and the
    compression results, from the ranks' records."""
    from repro_torch.core.pipeline import bubble_efficiency
    from repro_torch.train.compression import wire_bytes_compressed, wire_bytes_dense

    cfg = _pipeline_cfg()
    ok, err, scale = _close(ranks[0]["pipeline"]["dist_pipeline"]["y"], y_ref, DIST_FWD_TOL)
    print(f"[dist_pipeline] GPipe forward, {DIST_RANKS} stages x 1 block, grid {cfg.grid}, "
          f"width {cfg.width}, batch {PIPE_BATCH} as {PIPE_MICRO} micro-batches: rank 0's output "
          f"vs the serial fused forward max|d|={err:.3e} (max|ref|={scale:.3e}, rtol "
          f"{DIST_FWD_TOL[0]:g}, atol {DIST_FWD_TOL[1]:g}); {gpu}")
    if not ok:
        raise SystemExit("[dist_pipeline] the pipeline's output is outside the gate")
    for r, res in enumerate(ranks):
        for leaf, c in res["pipeline"]["dist_pipeline"]["grads"].items():
            if not c["ok"]:
                raise SystemExit(f"[dist_pipeline] stage {r}: gradient of {leaf} outside the gate "
                                 f"(max|d|={c['max_d']:.3e}, max|ref|={c['max_ref']:.3e}, atol "
                                 f"{c['atol'][0]:.3e} to {c['atol'][1]:.3e})")
            if c["passed_wrong"]:
                raise SystemExit(f"[dist_pipeline] stage {r}: the gate of {leaf} also passes: "
                                 f"{', '.join(c['passed_wrong'])}")
    for leaf, c in ranks[0]["pipeline"]["dist_pipeline"]["grads"].items():
        worst = max(res["pipeline"]["dist_pipeline"]["grads"][leaf]["max_d"] for res in ranks)
        print(f"[dist_pipeline] backward, gradient of {leaf} (each stage its own block): "
              f"worst max|d| over the stages {worst:.3e}, max|ref| {c['max_ref']:.3e}, gate rtol "
              f"{DIST_GRAD_TOL[0]:g} atol {c['atol'][0]:.3e} to {c['atol'][1]:.3e}; {gpu}")
    print(f"[dist_pipeline] every stage's gradients within the gate, which refuses zeros, "
          f"{DIST_RANKS} times the gradient, ci/co swapped and the next stage's block; {gpu}")
    ideal = bubble_efficiency(DIST_RANKS, PIPE_MICRO)
    for r, res in enumerate(ranks):
        trace = res["pipeline"]["dist_pipeline"]["trace"]
        ticks = [t for t in trace if "tick" in t]
        wall = trace[-1]["wall_s"]
        busy = sum(t.get("block_s", 0.0) for t in ticks)
        send = sum(t.get("send_s", 0.0) for t in ticks)
        recv = sum(t.get("recv_s", 0.0) for t in ticks)
        per_tick = "; ".join(
            f"t{t['tick']}: " + ("bubble" if t["micro"] is None else
                                 ", ".join(f"{k[:-2]} {t[k]:.3f}s" for k in
                                           ("recv_s", "block_s", "send_s") if k in t))
            for t in ticks)
        print(f"[dist_pipeline] stage {r}: forward + backward {res['pipeline']['dist_pipeline']['s']:.3f}s, "
              f"max_memory_allocated {res['pipeline']['dist_pipeline']['peak_gib']:.2f} GiB; {gpu}")
        print(f"[dist_pipeline] stage {r}: forward {wall:.3f}s, blocks {busy:.3f}s, sends "
              f"{send:.3f}s, receives (incl. waiting) {recv:.3f}s, bubble "
              f"{wall - busy - send:.3f}s; busy share {busy / wall:.3f} vs bubble_efficiency("
              f"{DIST_RANKS}, {PIPE_MICRO}) {ideal:.3f}; ticks: {per_tick}; {gpu}")
    for r, res in enumerate(ranks):
        for what, c in res["compression"]["leaves"].items():
            if not c["ok"]:
                raise SystemExit(f"[dist_compression] rank {r}: {what} outside its gate "
                                 f"(max|d|={c['max_d']:.3e})")
    for what in ranks[0]["compression"]["leaves"]:
        worst = max(res["compression"]["leaves"][what]["max_d"] for res in ranks)
        secs = ", ".join(f"{res['compression']['leaves'][what]['s']:.3f}" for res in ranks)
        tol = COMP_DENSE_TOL if what.endswith(" 1") else COMP_CONSERVE_TOL
        print(f"[dist_compression] {COMP_LEAF_BYTES >> 20} MiB {what} over {DIST_RANKS} ranks: "
              f"worst max|d| {worst:.3e} ({'reduced vs the dense mean, zero residual' if tol is COMP_DENSE_TOL else 'reduced + mean residual vs the dense mean'}, "
              f"rtol {tol[0]:g}, atol {tol[1]:g}); seconds a rank {secs}; {gpu}")
    n = cfg.width ** 2 * int(np.prod(cfg.mode_shape)) * cfg.n_blocks // DIST_RANKS
    for ratio in COMP_RATIOS:
        print(f"[dist_compression] wire bytes a rank of the {n * 8 / 1e9:.2f} GB w_spec shard "
              f"over {DIST_RANKS} ranks at ratio {ratio:g}: dense all-reduce "
              f"{wire_bytes_dense(n, 8, DIST_RANKS) / 1e9:.3f} GB, compressed "
              f"{wire_bytes_compressed(n, 8, DIST_RANKS, ratio) / 1e9:.3f} GB")


def phase_dist(gpu: str) -> dict:
    """The domain-decomposed FNO on 4 gloo ranks sharing this card, 1-D
    (paper Alg. 2, P = 4) and 2-D pencils (2 x 2), and its distributed
    training, in one launch of the ranks (``_dist_rank``): the served
    grid's paper forwards, the training grid's other schedules and a paper
    backward of each layout, then ``DIST_TRAIN_RUNS``. Before it, this
    process computes every serial reference and frees the card: the
    forwards' outputs, the training gradient and the train runs' params go
    to the host (``w_spec`` to files the ranks read a block at a time).
    Gates the
    forwards and backwards here (``phase_dist_train`` gates the train
    runs); returns the kernel timings at the shard shapes, each path's
    launches per rank, and the train runs' results and references."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs.fno_sleipner import CONFIG as PAPER_CONFIG
    from repro_torch.core.fno import fno_forward
    from repro_torch.launch.mesh import launch_ranks
    from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree

    _free_cuda()
    t0 = time.perf_counter()
    timed = _dist_kernel_times(gpu)
    print(f"[dist] shard kernels held and timed in {time.perf_counter() - t0:.1f}s")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    serve_cfg, train_cfg = _serving_cfg(), _dist_train_cfg(DIST_GRID_BLOCKS)
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"[dist] {DIST_RANKS} gloo ranks on {torch.cuda.get_device_name(0)} (NCCL refuses "
          f"two ranks on one device), as 1 x {DIST_RANKS} (x sharded) and 1 x "
          f"{DIST_PENCILS[0]}x{DIST_PENCILS[1]} (x and y pencils); served grid {serve_cfg.grid} "
          f"batch {DIST_SERVE_BATCH}, training grid {train_cfg.grid} batch {DIST_TRAIN_BATCH}, "
          f"width {serve_cfg.width}, modes {serve_cfg.modes}, {serve_cfg.n_blocks} blocks")
    print(f"reduced: dist_grady31 n_blocks {serve_cfg.n_blocks} -> {DIST_GRADY31_BLOCKS} "
          f"(the script's time; full width)")
    print(f"reduced: the training grid's dist forwards and backward n_blocks "
          f"{serve_cfg.n_blocks} -> {DIST_GRID_BLOCKS} (the script's time; full width)")
    print(f"reduced: dist2d_ensemble rollout steps 2 -> {DIST_ENSEMBLE_STEPS} (the script's "
          f"time)")
    print(f"reduced: dist_pipeline grid {'x'.join(map(str, PAPER_CONFIG.grid))} -> "
          f"{'x'.join(map(str, _pipeline_cfg().grid))} (4 ranks on one card; full width, "
          f"{_pipeline_cfg().n_blocks} blocks = {DIST_RANKS} stages)")
    print(f"reduced: dist_fleet grid {'x'.join(map(str, PAPER_CONFIG.grid))} -> "
          f"{'x'.join(map(str, train_cfg.grid))} (two replicas' shards on 4 ranks of one card; "
          f"full width)")
    print(f"reduced: dist2d_ensemble grid {'x'.join(map(str, serve_cfg.grid))} -> "
          f"{'x'.join(map(str, train_cfg.grid))} (rank 0's numpy spectral prefix sets a cold "
          f"tick's time; full width)")

    def gate(tag, got, ref, tol):
        ok, err, scale = _close(got, ref, tol)
        print(f"[dist] {tag}: max|d|={err:.3e} (max|ref|={scale:.3e}, rtol {tol[0]:g}, "
              f"atol {tol[1]:g}); {gpu}")
        if not ok:
            raise SystemExit(f"[dist] {tag}: outside the gate")

    def gathered(ranks, part, tag):
        if not tag.startswith("dist2d"):
            return torch.cat([r[part][tag]["y"] for r in ranks], dim=2)  # x is dim 2
        px, py = DIST_PENCILS  # rank i * py + j holds x shard i, y shard j
        rows = [torch.cat([ranks[i * py + j][part][tag]["y"] for j in range(py)], dim=3)
                for i in range(px)]
        return torch.cat(rows, dim=2)

    # the served grid's reference
    params = _dist_params(serve_cfg, DIST_SEED, dev)
    with torch.inference_mode():
        y_serve = fno_forward(params, _dist_input(serve_cfg, DIST_SERVE_BATCH, DIST_SEED, dev),
                              serve_cfg).cpu()
    del params
    _free_cuda()
    # the training grid's (seeded one further): the serial gradient, the
    # forward, and Grady-31's forward at its depth
    params = _dist_params(train_cfg, DIST_SEED + 1, dev)
    x = _dist_input(train_cfg, DIST_TRAIN_BATCH, DIST_SEED + 1, dev)
    grad_ref, y_train = zeros_like_tree(params), {}

    def loss(prm, b):
        y_train["y"] = fno_forward(prm, b["x"], train_cfg)
        return y_train["y"].square().mean(), {}

    accumulate_grads(loss, params, {"x": x}, grad_ref)
    y_train = y_train["y"].detach().cpu()
    with torch.inference_mode():
        y_grady31 = fno_forward(_first_blocks(params, DIST_GRADY31_BLOCKS), x, dataclasses.replace(
            train_cfg, n_blocks=DIST_GRADY31_BLOCKS)).cpu()
    # each leaf's max|ref|, which scales its gate (block by block: w_spec's
    # gradient is 12.6 GB)
    grad_max = {f"{group_name}.{name}": max(float(t.abs().max()) for t in g)
                for group_name, leaves in grad_ref.items() for name, g in leaves.items()}
    del params, x
    with tempfile.TemporaryDirectory() as d:
        # the references leave the card: w_spec's to a file, the rest to the host
        grad_w_spec_path = os.path.join(d, "grad_w_spec.npy")
        _to_file(grad_ref["blocks"].pop("w_spec"), grad_w_spec_path)
        grad_ref = {g: {n: v.cpu() for n, v in leaves.items()} for g, leaves in grad_ref.items()}
        _free_cuda()
        train_refs, train_runs = {}, []
        for tag, shards, n_blocks, batch, accum, steps in DIST_TRAIN_RUNS:
            path = os.path.join(d, f"{tag}_w_spec.npy")
            ref = _serial_train_reference(tag, _dist_train_cfg(n_blocks), batch, accum, steps,
                                          gpu, path)
            train_refs[tag] = ref
            train_runs.append({"tag": tag, "shards": shards, "n_blocks": n_blocks,
                               "batch": batch, "accum": accum, "steps": steps,
                               "ref": ref["ref"], "param_max": ref["param_max"],
                               "w_spec_path": path})
        pipe_job, y_pipe = _pipeline_reference(d)
        print(f"[dist] serial references computed and written in {time.perf_counter() - t0:.1f}s; "
              f"this process before the ranks start: {_memory_line()}", flush=True)
        t = time.perf_counter()
        ranks = launch_ranks(_dist_rank, DIST_RANKS, d,
                             args=({"seed": DIST_SEED, "grad_ref": grad_ref, "grad_max": grad_max,
                                    "grad_w_spec_path": grad_w_spec_path,
                                    "train_runs": train_runs, "pipe": pipe_job},),
                             deadline_s=DIST_TIMEOUT_S)
        print(f"[dist] {DIST_RANKS} ranks spawned, ran and joined in "
              f"{time.perf_counter() - t:.1f}s: served grid "
              + ", ".join(f"{r['serve']['wall_s']:.1f}" for r in ranks) + "s, training grid "
              + ", ".join(f"{r['train_grid']['wall_s']:.1f}" for r in ranks) + "s, pipeline "
              + ", ".join(f"{r['pipeline']['wall_s']:.1f}" for r in ranks) + "s, compression "
              + ", ".join(f"{r['compression']['wall_s']:.1f}" for r in ranks) + "s, fleet "
              + ", ".join(f"{r['fleet']['wall_s']:.1f}" for r in ranks) + "s, ensemble "
              + ", ".join(f"{r['ensemble']['wall_s']:.1f}" for r in ranks) + "s a rank")
    _check_pipeline(ranks, y_pipe, gpu)
    del y_pipe
    for tag, what in (("dist_paper", "1 x 4"), ("dist2d_paper", "1 x 2x2")):
        gate(f"FNORunner tick over {what} ranks (paper), grid {serve_cfg.grid}, bucket "
             f"{DIST_SERVE_BATCH}, rank 0's gathered outputs vs the serial fused forward",
             ranks[0]["serve"][tag]["y"], y_serve, DIST_FWD_TOL)
    del y_serve
    for tag, what in (("dist_paper", "1-D"), ("dist2d_paper", "2-D")):
        peaks = [res["serve"][tag]["peak_gib"] for res in ranks]
        for r, res in enumerate(ranks):
            tick = ", ".join(f"{k} {v:.3f}s" for k, v in res["serve"][tag]["ticks"][0].items())
            print(f"[dist] rank {r}: kernels loaded in {res['load_s']:.2f}s; {what} served tick "
                  f"{res['serve'][tag]['s']:.3f}s ({tick}), max_memory_allocated "
                  f"{peaks[r]:.2f} GiB; {gpu}")
        print(f"[dist] the ranks' max_memory_allocated at the served grid, {what}, sum to "
              f"{sum(peaks):.2f} of {total_gib:.2f} GiB ({total_gib - sum(peaks):.2f} GiB left); "
              f"per-shard times on one card, not a scaling result; {gpu}")
    for r, res in enumerate(ranks):
        for name, split in res["serve"]["split"].items():
            parts = ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            print(f"[dist] rank {r}: one {name} paper block at the served grid: {parts}; its "
                  f"all-to-alls' {res['serve']['split_wire'][name]}; {gpu}")
    t = time.perf_counter()
    _check_dist_ensemble(ranks, gpu)
    print(f"[dist2d_ensemble] checked in {time.perf_counter() - t:.1f}s")

    for tag, variant, chunks in DIST_TRAIN_FORWARDS + DIST2D_TRAIN_FORWARDS:
        what = "2-D " if tag.startswith("dist2d") else ""
        ref = y_grady31 if variant == "grady31" else y_train
        depth = f", {DIST_GRADY31_BLOCKS} block(s)" if variant == "grady31" else ""
        gate(f"{what}{variant} forward (comm_chunks={chunks}{depth}), grid {train_cfg.grid}, vs "
             f"the serial fused forward", gathered(ranks, "train_grid", tag), ref, DIST_FWD_TOL)
    for tag, ref, what in (("dist_paper_chunks2", "dist_paper_train", ""),
                           ("dist2d_paper_chunks2", "dist2d_paper_train", "2-D ")):
        gate(f"{what}paper comm_chunks=2 vs comm_chunks=1", gathered(ranks, "train_grid", tag),
             gathered(ranks, "train_grid", ref), DIST_CHUNK_TOL)
    for name in ("1d", "2d"):
        for r, res in enumerate(ranks):
            for leaf, c in res["train_grid"]["grads"][name].items():
                if not c["ok"]:
                    raise SystemExit(f"[dist] rank {r}: {name} gradient of {leaf} outside the "
                                     f"gate (max|d|={c['max_d']:.3e}, max|ref|={c['max_ref']:.3e}, "
                                     f"atol {c['atol'][0]:.3e} to {c['atol'][1]:.3e})")
                if c["passed_wrong"]:
                    raise SystemExit(f"[dist] rank {r}: the gate of the {name} gradient of {leaf} "
                                     f"also passes: {', '.join(c['passed_wrong'])}")
        for leaf, c in ranks[0]["train_grid"]["grads"][name].items():
            worst = max(res["train_grid"]["grads"][name][leaf]["max_d"] for res in ranks)
            lo = min(res["train_grid"]["grads"][name][leaf]["atol"][0] for res in ranks)
            hi = max(res["train_grid"]["grads"][name][leaf]["atol"][1] for res in ranks)
            print(f"[dist] {name} paper backward, gradient of {leaf}: max|ref|={c['max_ref']:.3e}, "
                  f"worst max|d| over the ranks {worst:.3e}, gate rtol {DIST_GRAD_TOL[0]:g} atol "
                  f"{lo:.3e} to {hi:.3e}; {gpu}")
        print(f"[dist] {name} paper backward: every leaf's gradient on every rank within its "
              f"gate, and every gate refuses zeros (w_spec also ci/co swapped and the "
              f"neighbouring shard along each sharded dim); {gpu}")

    # exact launches per rank on every path
    n_blocks, grid_blocks = serve_cfg.n_blocks, train_cfg.n_blocks
    want = {tag: {"fused": n_blocks, "dw": 0} for tag in ("dist_paper", "dist2d_paper")}
    want.update({t: {"fused": grid_blocks, "dw": 0}
                 for t, _, _ in DIST_TRAIN_FORWARDS + DIST2D_TRAIN_FORWARDS})
    want["dist_grady31"] = {"fused": DIST_GRADY31_BLOCKS, "dw": 0}
    want["dist2d_ensemble"] = {"fused": 2 * DIST_ENSEMBLE_STEPS * n_blocks, "dw": 0}
    want["dist_fleet"] = {"fused": 2 * n_blocks, "dw": 0}  # one tick on each replica
    want["dist_backward"] = want["dist2d_backward"] = {"fused": 3 * grid_blocks,
                                                       "dw": grid_blocks}
    # a pipeline stage's forward + backward: its one block per micro-batch
    # in the forward, the remat recompute and dx, and the cotangent kernel
    want["dist_pipeline"] = {"fused": 3 * PIPE_MICRO, "dw": PIPE_MICRO}
    counted = []
    for r, res in enumerate(ranks):
        res = {**res["serve"], **res["train_grid"], **res["pipeline"],
               "dist2d_ensemble": res["ensemble"], "dist_fleet": res["fleet"]}
        got = {tag: {"fused": res[tag]["fused"], "dw": res[tag]["dw"]} for tag in want}
        counts = ", ".join(f"{tag} {n['fused']}/{n['dw']}" for tag, n in got.items())
        times = ", ".join(f"{tag} {res[tag]['s']:.3f}s" for tag in want)
        print(f"[dist] rank {r}: wall {times}; launches fused/dW {counts}; {gpu}")
        if got != want:
            raise SystemExit(f"[dist] rank {r}: launches {got}, want {want}")
        counted.append(got)
    print(f"[dist] phase done in {time.perf_counter() - t0:.1f}s (the train runs' share of the "
          f"launch is printed by dist_train)")
    return {"timed": timed, "launches": counted[0],
            "train_runs": [r["dist_train"] for r in ranks], "train_refs": train_refs,
            "fno_p4": {"param_bytes": [r["serve"]["dist_paper"]["param_bytes"] for r in ranks],
                       "peak_gib": [r["serve"]["dist_paper"]["peak_gib"] for r in ranks]}}


def _check_dist_ensemble(ranks, gpu: str) -> None:
    """The deep-split ensemble of ``_dist_ensemble_part``: cold == warm
    bitwise on rank 0, the cache hit, each tick's split, and the served
    outputs against the unfused serial oracle on the card, computed here
    once the ranks have left it (``serve_pde.verify``)."""
    import torch

    from repro_torch.launch.serve_pde import verify
    from repro_torch.serve import FNORunner

    ens = ranks[0]["ensemble"]
    cold, warm = ens["outputs"]
    for rid, steps in cold.items():
        if not all(torch.equal(a, b) for a, b in zip(steps, warm[rid])):
            raise SystemExit(f"[dist2d_ensemble] rid {rid}: cold and warm outputs differ")
    stats = ens["cache"]
    print(f"[dist2d_ensemble] cold == warm bitwise on rank 0; cache hit-rate "
          f"{stats['hit_rate']:.3f} ({stats['hits']} hits / {stats['misses']} misses)")
    if not stats["hit_rate"] > 0:
        raise SystemExit("[dist2d_ensemble] the geomodel cache never hit")
    for r, res in enumerate(ranks):
        e = res["ensemble"]
        ticks = "; ".join(", ".join(f"{k} {v:.3f}s" for k, v in t.items()) for t in e["ticks"])
        print(f"[dist2d_ensemble] rank {r}: runner made in {e['made_s']:.2f}s, 2 passes in "
              f"{e['s']:.3f}s; ticks: {ticks}; {gpu}")
    cfg, dev = _ensemble_cfg(), torch.device("cuda")
    _free_cuda()
    oracle = FNORunner(cfg, _dist_params(cfg, DIST_SEED + 2, dev), device=dev, max_slots=1,
                       n_static=1)
    done = _ensemble_requests(cfg)
    for r in done:
        r.outputs = [y.numpy() for y in cold[r.rid]]
    worst = verify(oracle, done, DIST_ENSEMBLE_STEPS)
    print(f"[dist2d_ensemble] verify OK: {len(done)} scenarios x {DIST_ENSEMBLE_STEPS} steps vs "
          f"the unfused serial oracle (max abs diff {worst:.3e}, rtol 1e-4, atol 1e-5); {gpu}")
    _check_dist_fleet(ranks, oracle.params, gpu)  # the same seeded weights
    del oracle
    _free_cuda()


# ---------------------------------------------------------------------------
# Phase dist_train: the distributed train step on 4 gloo ranks sharing the
# card (run in phase dist's launch of the ranks), against the serial train
# step on it.
# ---------------------------------------------------------------------------

DIST_TRAIN_SEED = 13
DIST_TRAIN_TOL = (1e-4, 1e-5)  # rtol, atol of losses, grad norms and params
# (tag, --model-shards, n_blocks, global batch, micro-batches, steps)
DIST_TRAIN_RUNS = (
    # 1 data x 2x2 pencils, n_blocks 4 -> 2, steps 3 -> 2 (the script's time)
    ("dist_train_pencils", [2, 2], 2, 2, 2, 2),
    # 2 data x 2 model (1-D), ZeRO-1, n_blocks 4 -> 2: at 4 blocks a rank's
    # state (w_spec shard 6.3 GB, its gradient 6.3, half of mu 3.15 and of
    # nu 1.6) is 17.3 GB, 69 GB for four ranks before any activation;
    # steps 2 -> 1 (the script's time: a step is 8-13 s of host-staged
    # data-group collectives)
    ("dist_train_dp2", [2], 2, 2, 1, 1),
)
# The steps each run took before the cut, for its reduced: line
DIST_TRAIN_STEPS_BEFORE = {"dist_train_pencils": 3, "dist_train_dp2": 2}


def _dist_train_cfg(n_blocks: int):
    import dataclasses

    return dataclasses.replace(_train_cfg(), n_blocks=n_blocks)


def _dist_train_run(rank, world_size, device, job) -> dict:
    """One distributed training run on this rank: the trainer's pieces
    (``forward_and_specs``, ``state_layout`` with ZeRO-1, the per-rank
    loader, ``make_train_step`` with the layout) for ``job["steps"]``
    steps from the seeded params, each step split into its gradient
    reduction, its AdamW update and the rest; then every param leaf held
    against the matching slice of the serial run's by ``_gate_leaf``
    (``w_spec`` read block by block from the serial run's file)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.core.fno import (
        forward_and_specs, group_names, init_params, mse_loss, param_shapes,
    )
    from repro_torch.core.partition import shard_tree
    from repro_torch.launch.comm_analysis import wire_line
    from repro_torch.data.loader import NdArraySource, ShardedDatasetLoader
    from repro_torch.launch.mesh import build_fno_groups
    from repro_torch.launch.train import synthetic_fno_data
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, state_layout, warmup_cosine

    events = {}

    def mark(name):  # the step's hook: a CUDA event where its parts meet
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    cfg = _dist_train_cfg(job["n_blocks"])
    data_group, model, _ = build_fno_groups(world_size, job["shards"])
    groups = group_names(data_group, model)
    forward, x_part, p_parts = forward_and_specs(cfg, model)
    layout = state_layout(groups, p_parts, param_shapes(cfg), zero1=True)
    for turn in range(world_size):  # one full copy of the weights at a time
        if turn == rank:
            gen = torch.Generator(device=device).manual_seed(DIST_TRAIN_SEED)
            params = shard_tree(init_params(cfg, generator=gen, device=device), p_parts, groups)
            torch.cuda.empty_cache()
        dist.barrier()
    opt = init_opt_state(params, layout)
    x_all, y_all = synthetic_fno_data(cfg, 4, seed=0)
    step = train_loop.make_train_step(lambda p, b: (mse_loss(forward(p, b["x"]), b["y"]), {}),
                                      AdamWConfig(lr=warmup_cosine(1e-3, 10, job["steps"])),
                                      grad_accum=job["accum"], layout=layout, mark=mark)
    loader = ShardedDatasetLoader({"x": NdArraySource(x_all), "y": NdArraySource(y_all)},
                                  job["batch"], device=device, seed=0, part=x_part, groups=groups)
    out = {"steps": []}
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for i in range(job["steps"]):
            batch = loader.batch(i)
            with collectives.timed(sync=False) as count:  # counted, not waited on
                (params, opt, m), run = _counted(lambda: step(params, opt, batch))
            # the step's split from its CUDA events (``_counted`` synchronised):
            # the gradient reduction and the sharded AdamW update, in seconds
            split = {"reduce_grads": events["backward"].elapsed_time(events["reduced"]) / 1e3,
                     "adamw_update": events["reduced"].elapsed_time(events["updated"]) / 1e3}
            out["steps"].append({**{k: float(v) for k, v in m.items()}, **run, **split,
                                 "wire": wire_line(count["ops"])})
    finally:
        loader.close()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["mu_gb"] = sum(t.numel() * t.element_size() for t in _leaves(opt["mu"])) / 1e9
    del opt, step
    torch.cuda.empty_cache()
    w_ref = np.load(job["w_spec_path"], mmap_mode="r")
    checked = {}
    for group_name, leaves in params.items():
        for name, p in leaves.items():
            part = p_parts[group_name][name]
            ref = (job["ref"][group_name][name].to(device) if part is None else
                   lambda i: torch.from_numpy(np.array(w_ref[i])).to(device))
            checked[f"{group_name}.{name}"] = _gate_leaf(
                p, ref, part, groups, DIST_TRAIN_TOL, job["param_max"][f"{group_name}.{name}"])
    out["params"] = checked
    return out


def _to_file(w, path: str) -> None:
    """A stacked complex64 tensor on the card into a .npy file, block by
    block through one pinned host buffer, for ranks to read a block at a
    time. Not synced to disk: the ranks, on this machine, read it through
    the page cache."""
    import torch

    buf = torch.empty(tuple(w.shape[1:]), dtype=torch.complex64, pin_memory=True)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": np.lib.format.dtype_to_descr(np.dtype(np.complex64)),
            "fortran_order": False, "shape": tuple(w.shape)})
        for i in range(w.shape[0]):
            buf.copy_(w[i])
            f.write(buf.numpy().data)


def _serial_train_reference(tag, cfg, batch, accum, steps, gpu, w_spec_path) -> dict:
    """The serial train step on the card from the same seeded params and
    the same loader: each step's loss and grad norm, and the final params
    (w_spec saved to ``w_spec_path``, the other leaves on the host)."""
    import torch

    from repro_torch.core.fno import fno_forward, init_params, mse_loss
    from repro_torch.data.loader import NdArraySource, ShardedDatasetLoader
    from repro_torch.launch.train import synthetic_fno_data
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, warmup_cosine
    from repro_torch.train.train_loop import make_train_step

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(DIST_TRAIN_SEED)
    params = init_params(cfg, generator=gen, device=dev)
    opt = init_opt_state(params)
    x_all, y_all = synthetic_fno_data(cfg, 4, seed=0)
    step = make_train_step(lambda p, b: (mse_loss(fno_forward(p, b["x"], cfg), b["y"]), {}),
                           AdamWConfig(lr=warmup_cosine(1e-3, 10, steps)), grad_accum=accum)
    metrics = []
    with ShardedDatasetLoader({"x": NdArraySource(x_all), "y": NdArraySource(y_all)}, batch,
                              device=dev, seed=0) as loader:
        for i in range(steps):
            b = loader.batch(i)
            (params, opt, m), run = _counted(lambda: step(params, opt, b))
            metrics.append({**{k: float(v) for k, v in m.items()}, **run})
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] serial reference: {steps} steps, max_memory_allocated {peak:.2f} GiB; "
          f"{gpu}")
    del opt, step
    param_max = {f"{g}.{n}": max(float(t.abs().max()) for t in v) if g == "blocks"
                 else float(v.abs().max())
                 for g, leaves in params.items() for n, v in leaves.items()}
    _to_file(params["blocks"].pop("w_spec"), w_spec_path)
    ref = {g: {n: v.cpu() for n, v in leaves.items()} for g, leaves in params.items()}
    del params
    _free_cuda()
    return {"metrics": metrics, "ref": ref, "param_max": param_max, "peak_gib": peak}


def phase_dist_train(gpu: str, dist_out: dict) -> dict:
    """The distributed train runs of phase dist's launch (``DIST_TRAIN_RUNS``),
    each gated on every step's loss and grad norm against the serial run's,
    every param leaf after the last step against the matching slice of the
    serial params (``_gate_leaf``, its wrong controls refused on every
    rank), and exact launches a rank. Returns each run's launches per rank
    (rank 0's, all checked equal)."""
    launches = {}
    rtol, atol = DIST_TRAIN_TOL
    for tag, shards, n_blocks, batch, accum, steps in DIST_TRAIN_RUNS:
        ranks = [r[tag] for r in dist_out["train_runs"]]
        ref = dist_out["train_refs"][tag]
        n_dp = DIST_RANKS // int(np.prod(shards))
        print(f"[{tag}] {n_dp} data x {' x '.join(map(str, shards))} model on {DIST_RANKS} gloo "
              f"ranks sharing the card; grid {_train_cfg().grid}, width {_train_cfg().width}, "
              f"{n_blocks} blocks, batch {batch}, {accum} micro-batch(es) a data rank, {steps} "
              f"steps, ZeRO-1 over the data group; the run took "
              + ", ".join(f"{r['wall_s']:.1f}" for r in ranks) + "s a rank")
        if n_blocks != _train_cfg().n_blocks:
            print(f"reduced: n_blocks {_train_cfg().n_blocks} -> {n_blocks} ({tag})")
        print(f"reduced: steps {DIST_TRAIN_STEPS_BEFORE[tag]} -> {steps} ({tag}; the script's "
              f"time)")
        for i, want in enumerate(ref["metrics"]):
            for key in ("loss", "grad_norm"):
                for r, res in enumerate(ranks):
                    got = res["steps"][i][key]
                    if not abs(got - want[key]) <= atol + rtol * abs(want[key]):
                        raise SystemExit(f"[{tag}] rank {r} step {i}: {key} {got:.9e} vs the "
                                         f"serial {want[key]:.9e}, outside rtol {rtol:g}")
            print(f"[{tag}] step {i}: loss {ranks[0]['steps'][i]['loss']:.6e} (serial "
                  f"{want['loss']:.6e}), grad_norm {ranks[0]['steps'][i]['grad_norm']:.6e} "
                  f"(serial {want['grad_norm']:.6e}); wall a rank "
                  + ", ".join(f"{res['steps'][i]['s']:.3f}s (gradient reduction "
                              f"{res['steps'][i]['reduce_grads']:.3f}s, AdamW "
                              f"{res['steps'][i]['adamw_update']:.3f}s)" for res in ranks)
                  + f"; serial {want['s']:.3f}s; rank 0's collectives "
                  f"{ranks[0]['steps'][i]['wire']}; {gpu}")
        for r, res in enumerate(ranks):
            for leaf, c in res["params"].items():
                if not c["ok"]:
                    raise SystemExit(f"[{tag}] rank {r}: param {leaf} outside the gate "
                                     f"(max|d|={c['max_d']:.3e}, max|ref|={c['max_ref']:.3e}, "
                                     f"atol {c['atol'][0]:.3e} to {c['atol'][1]:.3e})")
                if c["passed_wrong"]:
                    raise SystemExit(f"[{tag}] rank {r}: the gate of param {leaf} also passes: "
                                     f"{', '.join(c['passed_wrong'])}")
        for leaf, c in ranks[0]["params"].items():
            worst = max(res["params"][leaf]["max_d"] for res in ranks)
            print(f"[{tag}] param {leaf} after step {steps - 1}: max|ref|={c['max_ref']:.3e}, "
                  f"worst max|d| over the ranks {worst:.3e}; {gpu}")
        print(f"[{tag}] every param leaf on every rank within its gate (rtol {rtol:g}, atol at "
              f"most {atol:g} and {DIST_GRAD_LEAF_ATOL:g} of its scale), and every gate refuses "
              f"zeros (w_spec also ci/co swapped and the neighbouring shard along each sharded "
              f"dim); {gpu}")
        want = {"fused": steps * n_blocks * 3 * accum, "dw": steps * n_blocks * accum}
        for r, res in enumerate(ranks):
            got = {k: sum(s[k] for s in res["steps"]) for k in ("fused", "dw")}
            print(f"[{tag}] rank {r}: launches fused {got['fused']}, dw {got['dw']} (want "
                  f"{want['fused']}, {want['dw']}); max_memory_allocated {res['peak_gib']:.2f} "
                  f"GiB; AdamW moments mu {res['mu_gb']:.2f} GB; {gpu}")
            if got != want:
                raise SystemExit(f"[{tag}] rank {r}: launches {got}, want {want}")
        launches[tag] = {k: sum(s[k] for s in ranks[0]["steps"]) for k in ("fused", "dw")}
    return launches


def phase_dist_train_cli(gpu: str) -> dict:
    """The training CLI on 4 ranks (1 data x 2x2 pencils) through an
    injected fault, then the serving CLI with --verify on its checkpoint,
    on one card and on 4 ranks (``--devices 4 --model-shards 2 2``);
    returns rank 0's launches and the served runs'."""
    import tempfile

    _free_cuda()  # the subprocesses need the memory this process has cached
    print(f"reduced: 4-rank train CLI steps 6 -> {CLI_STEPS} (the script's time)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    tag = "dist_train_cli"
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--devices", str(DIST_RANKS),
               "--model-shards", *map(str, DIST_PENCILS), "--steps", str(CLI_STEPS),
               "--save-every", "2",
               "--inject-fault", "3", "--width", "8", "--n-data", "8", "--use-pallas",
               "--ckpt-dir", d]
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        print("\n".join(f"[{tag}] " + line for line in out.stdout.strip().splitlines()))
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"[{tag}] train exited {out.returncode}")
        if "failures=1 restores=1" not in out.stdout:
            raise SystemExit(f"[{tag}] the injected fault was not restored from a checkpoint")
        m = re.search(r"spectral kernel launches: fused (\d+), dw (\d+) over (\d+) train steps "
                      r"x (\d+) blocks x (\d+) micro-batches \(rank 0 of (\d+)\)", out.stdout)
        if m is None:
            raise SystemExit(f"[{tag}] train printed no kernel launch counts")
        fused, dw, n_steps, n_blocks, accum, n_ranks = map(int, m.groups())
        if n_steps == 0 or fused != n_steps * n_blocks * 3 * accum or dw != n_steps * n_blocks * accum \
                or n_ranks != DIST_RANKS:
            raise SystemExit(f"[{tag}] launches fused {fused}, dw {dw} do not match "
                             f"{n_steps} steps x {n_blocks} blocks x {accum} micro-batches")
        served = {}
        for key, layout in (("serve", ["--devices", "1", "--model-shards", "1"]),
                            ("serve_4", ["--devices", str(DIST_RANKS), "--model-shards",
                                         *map(str, DIST_PENCILS)])):
            serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve_pde", "--ckpt-dir", d,
                         "--scenarios", "4", "--max-batch", "2", "--rollout-steps", "2",
                         "--verify", *layout]
            t = time.perf_counter()
            srv = subprocess.run(serve_cmd, capture_output=True, text=True, env=env, timeout=600)
            print("\n".join(f"[{tag} {key}] " + line for line in srv.stdout.strip().splitlines()))
            if srv.returncode != 0 or "verify OK" not in srv.stdout:
                print(srv.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"[{tag} {key}] serve_pde exited {srv.returncode} without "
                                 f"verify OK")
            m = re.search(r"spectral kernel launches: (\d+) over (\d+) forwards", srv.stdout)
            if m is None:
                raise SystemExit(f"[{tag} {key}] serve_pde printed no spectral kernel launch "
                                 f"count")
            served[key] = _check_launches(f"{tag} {key}", int(m.group(1)), n_blocks,
                                          int(m.group(2)), gpu)
            print(f"[{tag} {key}] {' '.join(layout)}: {time.perf_counter() - t:.1f}s")
    print(f"[{tag}] rank 0 of {DIST_RANKS} launched fused {fused}, dw {dw} over {n_steps} "
          f"steps; {gpu}")
    return {"fused": fused, "dw": dw, **served}


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def _lm_check(tag, got, ref) -> float:
    """Fail unless got is within the gate of its dtype (``LM_F32_TOL``,
    ``LM_BF16_*``) of ref everywhere; returns max|d|."""
    if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
        raise SystemExit(f"[{tag}] {tuple(got.shape)} {got.dtype} != {tuple(ref.shape)} {ref.dtype}")
    import torch

    g, r = got.float(), ref.float()
    d = (g - r).abs()
    err, top = float(d.max()), float(r.abs().max())
    if got.dtype == torch.float32:
        rel, absolute = LM_F32_TOL, LM_F32_TOL
    else:
        rel, absolute = LM_BF16_REL, LM_BF16_ABS_OF_MAX * top
    excess = float((d - (absolute + rel * r.abs())).max())
    print(f"[{tag}] max|d|={err:.3e} (gate {absolute:.3g} + {rel:.3g}|ref|, max|ref|={top:.3e})")
    if not excess <= 0 or not _finite(g):
        raise SystemExit(f"[{tag}] kernel disagrees with its plain version")
    return err


def _rmsnorm_bound_ms(rows, d, nbytes_el) -> tuple:
    """x read once, w once, y written once; 4 f32 flops per element."""
    nbytes = 2 * rows * d * nbytes_el + 4 * d
    return _bound_ms(nbytes, 4 * rows * d)


def _flash_bound_ms(b, h, kvh, sq, sk, d, causal, nbytes_el, dv=None) -> tuple:
    """q, k (head dim d), v and o (head dim dv, default d) read or written
    once; 2 (d + dv) flops per visible (query, key) pair (the causal cut
    counted for these lengths), against the tensor-core rate for bf16
    operands (whose products are exact in f32) and the f32 rate for f32."""
    dv = d if dv is None else dv
    if causal:
        pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq))
    else:
        pairs = sq * sk
    nbytes = nbytes_el * (d + dv) * (b * h * sq + b * kvh * sk)
    flops = 2 * (d + dv) * b * h * pairs
    rate = BF16_FLOP_PER_S if nbytes_el == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _launch_floor(gpu: str, decode: dict) -> dict:
    """The empty kernel's time, as the kernels here are timed: between two
    CUDA events around one launch, per launch around 50 back to back, and
    its device time from the profiler; printed beside rmsnorm's decode
    reading and bound."""
    import ctypes

    import torch

    from repro_torch.kernels.build import build

    lib = ctypes.CDLL(build([_empty_kernel_library()])[0])  # built in phase 1
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def empty():
        err = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"[launch floor] the empty kernel did not launch (CUDA error {err})")

    floor = {"events_one": cuda_ms(empty), "events_loop": cuda_loop_ms(empty)}
    floor["device"], floor["device_timed_by"] = device_ms(empty)
    print(f"[launch floor] empty kernel: {floor['events_one'] * 1e3:.2f} us between two CUDA "
          f"events around one launch, {floor['events_loop'] * 1e3:.2f} us a launch back to back, "
          f"{floor['device'] * 1e3:.2f} us device time (profiler); rmsnorm at decode [4, 3072] "
          f"bf16: {decode['ms'] * 1e3:.2f} us device time, {decode['call_ms'] * 1e3:.2f} us a call "
          f"back to back, bound {decode['bound_ms'] * 1e3:.2f} us; {gpu}")
    return floor


def phase_lm_kernels(gpu: str) -> tuple:
    """RMSNorm and flash attention vs their plain versions on the card, then
    timed at the serving path's shapes; returns their two records."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_cuda,
        flash_attention_ref,
    )
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    types = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(types[dtype])

    # rmsnorm: (rows, d, dtype); the timed ones (bf16 at d 3072, 2048, 512,
    # 1024 and 2560) are a gemma-7b prefill of 1000 tokens and a decode step
    # over 4 slots, deepseek-v2-lite's ln1/ln2/final_norm (d_model 2048, also
    # mamba2-370m's gated norm over d_inner) and its latent norm (kv_norm, d
    # = kv_lora = 512), mamba2-370m's ln1/final_norm (d_model 1024) and
    # recurrentgemma-2b's norms (d_model 2560) at both
    timed_d = (3072, 2048, 512, 1024, 2560)
    rms_cases = [(1, 8, "float32"), (37, 96, "bfloat16"), (256, 96, "float32"),
                 (300, 8, "bfloat16"), (300, 3072, "float32"), (300, 3072, "bfloat16"),
                 (1000, 3072, "float32"), (4, 3072, "float32"),
                 (1000, 3072, "bfloat16"), (4, 3072, "bfloat16"),
                 (1000, 2048, "float32"), (1000, 2048, "bfloat16"), (4, 2048, "bfloat16"),
                 (1000, 512, "float32"), (1000, 512, "bfloat16"), (4, 512, "bfloat16"),
                 (1000, 1024, "float32"), (1000, 1024, "bfloat16"), (4, 1024, "bfloat16"),
                 (1000, 2560, "float32"), (1000, 2560, "bfloat16"), (4, 2560, "bfloat16"),
                 # a d that is no whole number of 16-byte vectors: the scalar path
                 (4, 100, "bfloat16"), (1000, 100, "float32")]
    rms = {}
    for rows, d, dtype in rms_cases + [(rows, d, dtype + " offset by one element")
                                       for rows, d, dtype in ((4, 3072, "bfloat16"),
                                                              (1000, 1024, "float32"))]:
        if dtype.endswith(" offset by one element"):
            # a contiguous view whose base is not 16-byte aligned: the scalar path
            x = randn((rows * d + 1,), dtype.split()[0], 3.0)[1:].view(rows, d)
        else:
            x = randn((rows, d), dtype, 3.0)
        w = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        got = rmsnorm(x, w)
        torch.cuda.synchronize()
        err = _lm_check(f"rmsnorm {rows}x{d} {dtype}", got, rmsnorm_ref(x, w))
        if not torch.equal(got, rmsnorm(x, w)):
            raise SystemExit(f"[rmsnorm] {rows}x{d} {dtype}: two runs differ")
        if d in timed_d and dtype == "bfloat16" and rows in (1000, 4):
            (ms, by_ms), (plain, by_plain), (lib, by_lib) = (
                device_ms(lambda: rmsnorm(x, w)), device_ms(lambda: rmsnorm_ref(x, w)),
                device_ms(lambda: F.rms_norm(x.float(), (d,), w, eps=1e-6).to(x.dtype)))
            call = cuda_loop_ms(lambda: rmsnorm(x, w))
            bound, by = _rmsnorm_bound_ms(rows, d, 2)
            lo, hi = RMSNORM_FIRST_US[rows, d]
            first = f"{lo:.2f}" if lo == hi else f"{lo:.2f}-{hi:.2f}"
            plan = rmsnorm_ops.launch_plan(rows, d, 2, True)
            print(f"[rmsnorm] {rows}x{d} bf16, device time: kernel {ms * 1e3:.2f} us "
                  f"({bound / ms:.0%} of bound; vec {plan.vec}, nv {plan.nv}, tpr {plan.tpr}, "
                  f"rpc {plan.rpc}), first version (recorded) {first} us, plain "
                  f"{plain * 1e3:.2f} us, F.rms_norm {lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
                  f"({by}); back-to-back calls of the wrapper {call * 1e3:.2f} us each; {gpu}")
            rms[rows, d] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=bound, bound_by=by, call_ms=call,
                                timed_by={"ms": by_ms, "plain_ms": by_plain, "library_ms": by_lib})
    prefill, decode = rms[1000, 3072], rms[4, 3072]
    floor = _launch_floor(gpu, decode)
    rms_record = {
        "name": "rmsnorm", "route": "cuda", "source": RMSNORM_SOURCE,
        "replaces": RMSNORM_REPLACES, "launches": None, **prefill,
        "shape": "x [1000, 3072] bf16 (a 1000-token prefill)",
        "decode_shape": "x [4, 3072] bf16", "decode_ms": decode["ms"],
        "decode_timed_by": decode["timed_by"], "decode_call_ms": decode["call_ms"],
        "decode_plain_ms": decode["plain_ms"], "decode_library_ms": decode["library_ms"],
        "decode_bound_ms": decode["bound_ms"], "decode_launch_floor_ms": floor,
        "kv_norm_shapes": {f"x [{rows}, {d}] bf16": {k: v for k, v in rms[rows, d].items()
                                                      if k != "max_abs_err"}
                           for rows, d in ((1000, 512), (4, 512))},
        "moe_d_model_shapes": {f"x [{rows}, {d}] bf16": {k: v for k, v in rms[rows, d].items()
                                                          if k != "max_abs_err"}
                               for rows, d in ((1000, 2048), (4, 2048))},
        "recurrent_d_model_shapes": {f"x [{rows}, {d}] bf16": {k: v for k, v in rms[rows, d].items()
                                                                if k != "max_abs_err"}
                                     for rows, d in ((1000, 1024), (4, 1024), (1000, 2560),
                                                     (4, 2560))},
    }

    # flash: (name, b, h, kvh, sq, sk, d, causal, dtype, timed)
    flash_cases = [
        ("mha causal", 2, 4, 4, 100, 100, 32, True, "float32", False),
        ("gqa ragged", 1, 8, 2, 130, 130, 64, True, "bfloat16", False),
        ("mqa sq<sk", 1, 4, 1, 50, 200, 16, True, "float32", False),
        ("non-causal cross", 2, 2, 2, 64, 192, 128, False, "float32", False),
        ("d256 causal", 1, 2, 2, 140, 140, 256, True, "bfloat16", False),
        ("d256 gqa sq<sk", 1, 4, 2, 33, 129, 256, True, "float32", False),
        ("mqa non-causal", 1, 4, 1, 70, 70, 128, False, "bfloat16", False),
        # the path shapes in f32 too, where the gate holds the arithmetic tight
        ("gemma-7b prefill f32", 1, 16, 16, 1000, 1000, 256, True, "float32", False),
        ("chatglm3-6b gqa prefill f32", 1, 32, 2, 777, 777, 128, True, "float32", False),
        ("minitron-8b prefill f32", 1, 32, 8, 1000, 1000, 128, True, "float32", False),
        ("gemma-7b prefill", 1, 16, 16, 1000, 1000, 256, True, "bfloat16", True),
        ("chatglm3-6b gqa prefill", 1, 32, 2, 777, 777, 128, True, "bfloat16", True),
        ("minitron-8b prefill", 1, 32, 8, 1000, 1000, 128, True, "bfloat16", True),
        # deepseek-v2-lite's MLA prefill (nope 128 + RoPE 64, v padded to 192),
        # and the reduced MLA config's head dim 24, padded to the 32 instance
        ("v2-lite mla prefill f32", 1, 16, 16, 1000, 1000, 192, True, "float32", False),
        ("v2-lite mla prefill", 1, 16, 16, 1000, 1000, 192, True, "bfloat16", True),
        ("reduced mla d24, padded to 32 (device time of the pads too)", 1, 4, 4, 77, 77, 24,
         True, "bfloat16", True),
        ("reduced mla d24 f32", 1, 4, 4, 77, 77, 24, True, "float32", False),
        # recurrentgemma-2b's local attention within its window: MQA, 10
        # query heads over 1 kv head (a group that is not a power of two)
        ("recurrentgemma-2b mqa prefill f32", 1, 10, 1, 1000, 1000, 256, True, "float32", False),
        ("recurrentgemma-2b mqa prefill", 1, 10, 1, 1000, 1000, 256, True, "bfloat16", True),
        # whisper-tiny (6 heads of 64, batch 4 of 1500 frames): the encoder's
        # non-causal self-attention (1500 = 23 x 64 + 28 keys, a ragged last
        # tile), the cross-attention of a 4-token prefill, of a decode step
        # (one query row in a 64-row tile) and of the loss's 448 tokens, and
        # the loss's causal decoder self-attention
        ("whisper-tiny encoder f32", 4, 6, 6, 1500, 1500, 64, False, "float32", False),
        ("whisper-tiny encoder", 4, 6, 6, 1500, 1500, 64, False, "bfloat16", True),
        ("whisper-tiny encoder b1", 1, 6, 6, 1500, 1500, 64, False, "bfloat16", True),
        ("whisper-tiny prefill cross f32", 4, 6, 6, 4, 1500, 64, False, "float32", False),
        ("whisper-tiny prefill cross", 4, 6, 6, 4, 1500, 64, False, "bfloat16", True),
        ("whisper-tiny decode cross f32", 4, 6, 6, 1, 1500, 64, False, "float32", False),
        ("whisper-tiny decode cross", 4, 6, 6, 1, 1500, 64, False, "bfloat16", True),
        ("whisper-tiny loss cross f32", 4, 6, 6, 448, 1500, 64, False, "float32", False),
        ("whisper-tiny loss cross", 4, 6, 6, 448, 1500, 64, False, "bfloat16", True),
        ("whisper-tiny loss self f32", 4, 6, 6, 448, 448, 64, True, "float32", False),
        ("whisper-tiny loss self", 4, 6, 6, 448, 448, 64, True, "bfloat16", True),
    ]
    flash = {}
    for name, b, h, kvh, sq, sk, d, causal, dtype, timed in flash_cases:
        # [b, s, heads, d] swapped to [b, heads, s, d]: the layer's strided views
        q = randn((b, sq, h, d), dtype).transpose(1, 2)
        k = randn((b, sk, kvh, d), dtype).transpose(1, 2)
        v = randn((b, sk, kvh, d), dtype).transpose(1, 2)
        before = flash_attention_cuda.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if flash_attention_cuda.launches != before + 1:
            raise SystemExit(f"[flash] {name}: {flash_attention_cuda.launches - before} launches")
        err = _lm_check(f"flash {name} b{b} h{h} kvh{kvh} sq{sq} sk{sk} d{d} {dtype}", got,
                        flash_attention_ref(q, k, v, causal=causal))
        if not timed:
            continue
        ms, by_ms = device_ms(lambda: flash_attention(q, k, v, causal=causal), n=10)
        plain, by_plain = device_ms(lambda: flash_attention_ref(q, k, v, causal=causal), n=5)
        mask = causal_lower_right(sq, sk) if causal else None
        lib, by_lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), n=10)
        bound, by = _flash_bound_ms(b, h, kvh, sq, sk, d, causal, 2)
        extra = {}
        if d == 192:
            # MLA's function needs v and o at dh_v = 128 only; the kernel
            # takes v padded to 192, which the bound above counts
            fbound, fby = _flash_bound_ms(b, h, kvh, sq, sk, d, causal, 2, dv=128)
            extra = dict(function_bound_ms=fbound, function_bound_by=fby)
            by += f"; unpadded v/o at 128: {fbound * 1e3:.2f} us ({fby})"
        print(f"[flash] {name}, device time: kernel {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
              f"{lib:.3f} ms (kernel / SDPA {ms / lib:.2f}), bound {bound * 1e3:.2f} us ({by}); {gpu}")
        flash[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bound, bound_by=by.split(";")[0], **extra,
                           timed_by={"ms": by_ms, "plain_ms": by_plain, "library_ms": by_lib})
        del q, k, v, got
        torch.cuda.empty_cache()
    flash_record = {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": None, **flash["gemma-7b prefill"],
        "shape": "q/k/v [1, 16, 1000, 256] bf16 causal (a gemma-7b prefill layer)",
        "other_shapes": {k: {key: v[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "function_bound_ms", "timed_by") if key in v}
                         for k, v in flash.items() if k != "gemma-7b prefill"},
    }
    return rms_record, flash_record


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the LM layers call the kernels' plain versions on
    CUDA tensors; for checking the served path, never on it."""
    import repro_torch.kernels.flash_attention as flash_pkg
    import repro_torch.kernels.rmsnorm as rms_pkg
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref

    saved = rms_pkg.rmsnorm, flash_pkg.flash_attention
    rms_pkg.rmsnorm = lambda x, w, eps=1e-6: rmsnorm_ref(x, w, eps)
    flash_pkg.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        rms_pkg.rmsnorm, flash_pkg.flash_attention = saved


LM_ARCH, LM_SLOTS, LM_REQUESTS, LM_MAX_TOKENS, LM_MAX_LEN = "gemma-7b", 4, 8, 16, 1040
# the MoE family's served config (gemma's traffic) and the CLI's archs
MOE_ARCH = "deepseek-v2-lite-16b"
# the SSM and hybrid families' served configs (gemma's traffic; recurrentgemma
# with two more requests: one past its window of 2048, one whose decode
# steps cross the ring's wrap at index 2048)
SSM_ARCH, HYBRID_ARCH = "mamba2-370m", "recurrentgemma-2b"
HYBRID_EXTRA = (2300, 2040)
RECURRENT_MAX_LEN = 2320
CLI_ARCHS = (LM_ARCH, MOE_ARCH, "deepseek-moe-16b", SSM_ARCH, HYBRID_ARCH)


@contextlib.contextmanager
def counted_drops():
    """Within the block, every MoE dispatch appends (tokens routed, entries
    dropped) to the list it yields; the dropped count stays a device tensor,
    so nothing waits for the device."""
    from repro_torch.models import moe as moe_lib

    seen, dispatch = [], moe_lib._dispatch

    def counted(x_flat, topi, capacity, n_experts, **kw):
        out = dispatch(x_flat, topi, capacity, n_experts, **kw)
        seen.append((topi.shape[0], topi.shape[1], (~out[3]).sum()))
        return out

    moe_lib._dispatch = counted
    try:
        yield seen
    finally:
        moe_lib._dispatch = dispatch


@contextlib.contextmanager
def routes(recorded=None):
    """Without ``recorded``: every MoE routing decision of the block (each
    ``_route``'s top-k experts) is appended to the list yielded. With the
    list of another run: that run's decisions are replayed in order, while
    the block computes its own router probabilities and takes its weights
    from them; ``flips`` in the yielded dict counts the tokens whose own
    top-k experts differ from the replayed ones, and ``tied`` those of
    them whose own k-th and (k+1)-th probabilities are equal (a tie of the
    bf16 router logits, which the lower expert wins). A plain run that replays
    the kernel run's routes checks the kernels' numbers and not the
    routing's discrete choices, which a rounding flips (and a flip moves
    every later entry of an expert past or inside its capacity)."""
    import torch

    from repro_torch.models import moe as moe_lib

    route = moe_lib._route
    out = {"routes": [] if recorded is None else recorded, "flips": 0, "tied": 0, "tokens": 0}
    replay = None if recorded is None else iter(recorded)

    def wrapped(x_flat, router_w, moe):
        topi, topv, probs = route(x_flat, router_w, moe)
        if replay is None:
            out["routes"].append(topi.clone())
            return topi, topv, probs
        want = next(replay)
        flipped = (topi.sort(-1).values != want.sort(-1).values).any(-1)
        edge = probs.sort(dim=-1, descending=True).values[:, moe.top_k - 1: moe.top_k + 1]
        out["flips"] += int(flipped.sum())
        out["tied"] += int((flipped & (edge[:, 0] == edge[:, 1])).sum())
        out["tokens"] += topi.shape[0]
        w = probs.gather(1, want)
        if moe.norm_topk:
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        return want, w.to(x_flat.dtype), probs

    moe_lib._route = wrapped
    try:
        yield out
    finally:
        moe_lib._route = route
    if replay is not None and next(replay, None) is not None:
        raise SystemExit("[routes] the replayed run routed fewer times than the recorded one")


def _drop_share(seen, prefill: bool) -> tuple:
    """(entries dropped, entries routed) of the prefills (more tokens than
    slots) or of the decode steps."""
    rows = [(t * k, int(n)) for t, k, n in seen if (t > LM_SLOTS) == prefill]
    return sum(n for _, n in rows), sum(e for e, _ in rows)


def _logit_pair(tag, what, got, ref, gate) -> float:
    """Fail unless got (through the kernels) is finite and within ``gate``
    x max|ref| of ref (through the plain versions); returns max|d| /
    max|ref|."""
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"[{tag}] {what}, kernels vs plain: max|d|={err:.3e} (gate {gate:.4g} x max|ref|="
          f"{scale:.3e})")
    if not _finite(got) or not err <= gate * scale:
        raise SystemExit(f"[{tag}] {what} disagrees with the plain path")
    return err / scale


def _serve_lm(gpu: str, arch: str, tag: str, extra: tuple = (), max_len: int = LM_MAX_LEN,
              bf16_gate=LM_LOGIT_GATE, f32_check: bool = False) -> dict:
    """``arch`` at full width through Engine (LM_REQUESTS requests on LM_SLOTS
    slots, and one more request for each prompt length in ``extra``), then
    2 prompts' logits through the kernels vs the plain versions (and each
    extra prompt's: under a sliding window the windowed prefill, and the
    decode step at the ring's wrap); returns the kernels' launch counts
    (and, for the MoE family, the prefills' drop share)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import init_lm_params, lm_decode_step, lm_prefill
    from repro_torch.models.transformer import flash_per_prefill, norms_per_forward
    from repro_torch.serve import Engine, Request

    cfg = get_arch(arch)
    if cfg.ssm:
        layout = (f"SSD mixers: d_inner {cfg.ssm.d_inner(cfg.d_model)}, {cfg.ssm.n_heads(cfg.d_model)} "
                  f"heads x {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk}")
    else:
        attn = (f"MLA {cfg.mla.kv_lora}/{cfg.mla.dh_nope}/{cfg.mla.dh_rope}/{cfg.mla.dh_v}"
                if cfg.mla else f"{cfg.n_heads} heads over {cfg.kv_heads} kv heads x {cfg.head_dim_}")
        if cfg.window:
            attn = (f"pattern {'/'.join(cfg.pattern)}, RG-LRU width "
                    f"{cfg.rglru.width(cfg.d_model)}, local attention {attn}, window {cfg.window}")
        ffn = (f"{cfg.moe.n_experts} routed experts top-{cfg.moe.top_k} + {cfg.moe.n_shared} shared "
               f"of width {cfg.moe.d_expert}, layer 0 dense {cfg.moe.first_dense_ff}"
               if cfg.moe else f"d_ff {cfg.d_ff}")
        layout = f"{attn}, {ffn}"
    print(f"[{tag}] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{layout}, vocab {cfg.vocab}, {cfg.approx_params() / 1e9:.2f} B params (the reference's "
          f"count); random weights (seed 0)")
    dev = torch.device("cuda")
    _free_cuda()
    t0 = time.perf_counter()
    # each leaf drawn in f32 and cast at once: the f32 masters never coexist
    params = init_lm_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev,
                            serving=True)
    engine = Engine(cfg, params, max_len=max_len, max_batch=LM_SLOTS, device=dev)
    del params
    torch.cuda.synchronize()
    runner = engine.runner
    held = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    cache = sum(t.numel() * t.element_size() for t in _leaves(runner.cache))
    draw_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] weights set up in {time.perf_counter() - t0:.1f}s, drawn leaf by leaf; peak "
          f"{draw_peak:.2f} GiB; the runner holds "
          f"{held / 1e9:.2f} GB of weights and a {cache / 1e9:.3f} GB cache; {gpu}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    rng = np.random.default_rng(0)
    lengths = np.concatenate([rng.integers(200, 1001, size=LM_REQUESTS), np.array(extra, int)])
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist() for n in lengths]
    n_requests = len(prompts)
    print(f"[{tag}] {n_requests} requests, prompt lengths {lengths.tolist()}, max_tokens "
          f"{LM_MAX_TOKENS}, max_len {max_len}, {LM_SLOTS} slots")
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt, max_tokens=LM_MAX_TOKENS))
    with counted_drops() as seen:
        rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        done = engine.run_until_done()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"rmsnorm": rmsnorm_cuda.launches, "flash": flash_attention_cuda.launches}
    if engine.failed:
        raise SystemExit(f"[{tag}] {len(engine.failed)} requests failed: {engine.failed[0].error!r}")
    if len(done) != n_requests or any(
            len(r.output) != LM_MAX_TOKENS or not all(0 <= t < cfg.vocab for t in r.output)
            for r in done):
        raise SystemExit(f"[{tag}] a request did not return max_tokens valid token ids")
    prefills, steps = len(runner.prefill_s), len(runner.decode_s)
    tokens = sum(len(r.output) for r in done)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] served {len(done)} requests, {tokens} tokens in {dt:.3f}s: "
          f"{tokens / dt:.1f} tok/s; {prefills} prefills, mean {np.mean(runner.prefill_s) * 1e3:.1f} ms "
          f"(prompt mean {lengths.mean():.0f} tokens); {steps} decode steps, mean "
          f"{np.mean(runner.decode_s) * 1e3:.2f} ms, median {np.median(runner.decode_s) * 1e3:.2f} ms; "
          f"max_memory_allocated while serving {peak:.2f} GiB; {gpu}")
    stats = {"requests": len(done), "tokens": tokens, "seconds": dt,
             "prefill_ms_mean": float(np.mean(runner.prefill_s) * 1e3),
             "decode_ms_mean": float(np.mean(runner.decode_s) * 1e3),
             "decode_ms_median": float(np.median(runner.decode_s) * 1e3), "peak_gib": peak,
             "tok_per_s": tokens / dt, "draw_peak_gib": draw_peak, "held_weights_gb": held / 1e9,
             "cache_gb": cache / 1e9}
    if cfg.moe:
        dropped, routed = _drop_share(seen, prefill=True)
        d_dropped, d_routed = _drop_share(seen, prefill=False)
        print(f"[{tag}] MoE drops: prefills {dropped} of {routed} routed entries "
              f"({dropped / routed:.4%}) over {sum(1 for t, _, _ in seen if t > LM_SLOTS)} "
              f"dispatches; decode steps {d_dropped} of {d_routed} (dropless: room for every slot)")
        if d_dropped or d_routed != steps * LM_SLOTS * cfg.moe.top_k * cfg.layer_kinds().count("moe"):
            raise SystemExit(f"[{tag}] the decode steps dropped routed entries or missed a layer")
        stats["prefill_drop_share"] = dropped / routed
    for r in sorted(done, key=lambda r: r.rid)[:2]:
        print(f"[{tag}]   req {r.rid}: {len(r.prompt)} prompt tokens -> {r.output}")
    # flash once per attention layer of each prefill within the window
    flash_each = [flash_per_prefill(cfg, len(p)) for p in prompts]
    want = {"rmsnorm": norms_per_forward(cfg) * (prefills + steps), "flash": sum(flash_each)}
    print(f"[{tag}] launches: rmsnorm {launches['rmsnorm']} (want {norms_per_forward(cfg)} x "
          f"({prefills} prefills + {steps} decode steps) = {want['rmsnorm']}), flash "
          f"{launches['flash']} (want {' + '.join(map(str, flash_each))} = {want['flash']} over the "
          f"prefills); {gpu}")
    if prefills != n_requests or launches != want:
        raise SystemExit(f"[{tag}] the served run did not launch the kernels as expected")

    # 2 prompts (and the extra ones) through the kernels and through the
    # plain versions; under MoE the plain run replays the kernel run's routes
    # (``routes``), and a third, free-running plain run is printed beside it,
    # ungated. A prompt that ends short of the ring's wrap under a window is
    # decoded, with the engine's tokens, up to the step at the wrap (index
    # ``window``), whose logits are held too. With ``f32_check`` the same
    # runs again with float32 activations on the same (bf16-valued) weights,
    # held at LM_F32_LOGIT_GATE; the served dtype's logits at ``bf16_gate``.
    first = {r.rid: r.output[0] for r in done}
    outputs = {r.rid: r.output for r in done}
    params = runner.params
    variants = [(cfg, bf16_gate)]
    if f32_check:
        variants.append((dataclasses.replace(cfg, dtype="float32"), LM_F32_LOGIT_GATE))
    stats["logit_rel_err"] = {}
    for rid in (0, 1) + tuple(range(LM_REQUESTS, n_requests)):
        prompt = torch.tensor([prompts[rid]], dtype=torch.long, device=dev)
        n = prompt.shape[1]
        wrap = cfg.window if cfg.window and n < cfg.window < n + LM_MAX_TOKENS else None
        feed = outputs[rid][: wrap - n + 1] if wrap else outputs[rid][:1]
        for run_cfg, gate in variants:
            out, record = {}, None
            for kind in ("kernels", "plain", "free") if cfg.moe else ("kernels", "plain"):
                with torch.inference_mode(), \
                        (plain_kernels() if kind != "kernels" else contextlib.nullcontext()), \
                        routes(record if kind == "plain" else None) as routed:
                    before = (rmsnorm_cuda.launches, flash_attention_cuda.launches)
                    logits, cache = lm_prefill(params, prompt, run_cfg, max_len=n + len(feed))
                    tok = torch.argmax(logits, -1)[:, None]
                    steps_out = []
                    for i, t in enumerate(feed):  # the engine's tokens: the same on both runs
                        step, _ = lm_decode_step(params, torch.tensor([[t]], device=dev), cache,
                                                 n + i, run_cfg)
                        steps_out.append(step.float())
                    moved = (rmsnorm_cuda.launches, flash_attention_cuda.launches) != before
                    if moved != (kind == "kernels"):
                        raise SystemExit(f"[{tag}] the {kind} check did not run through the {kind}")
                    out[kind] = (logits.float(), steps_out[0], int(tok), steps_out[-1])
                    del cache
                if kind == "kernels":
                    record = routed["routes"]
                elif kind == "plain" and cfg.moe:
                    print(f"[{tag}] req {rid}: the plain run replays the kernel run's routes; its "
                          f"own top-{cfg.moe.top_k} would differ for {routed['flips']} of "
                          f"{routed['tokens']} token routings (prefill + first decode step), "
                          f"{routed['tied']} of them on a tie of its bf16 router logits")
            if run_cfg is cfg and out["kernels"][2] != first[rid]:
                raise SystemExit(f"[{tag}] req {rid}: prefill's greedy token {out['kernels'][2]} != "
                                 f"the engine's {first[rid]}")
            checks = [(0, "prefill last-token"), (1, "first decode step")]
            if wrap:
                checks.append((3, f"decode step at index {wrap}, past the ring's wrap"))
            elif cfg.window and n > cfg.window:
                checks[0] = (0, f"windowed prefill ({n} > window {cfg.window}, no flash) last-token")
            for i, what in checks:
                got, ref = out["kernels"][i], out["plain"][i]
                if "free" in out and i < 2:
                    free = out["free"][i]
                    print(f"[{tag}] req {rid} free-running plain run (its own routes; not gated): "
                          f"max|d|={float((got - free).abs().max()):.3e}, greedy token "
                          f"{int(free.argmax())}")
                stats["logit_rel_err"][f"req {rid} {what} {run_cfg.dtype}"] = _logit_pair(
                    tag, f"req {rid} ({n} tokens) {what} logits, {run_cfg.dtype} activations "
                    f"(greedy tokens {int(got.argmax())} / {int(ref.argmax())})", got, ref, gate)
    del engine, runner, params
    _free_cuda()
    return {**launches, "stats": stats}


def phase_lm_serving(gpu: str) -> dict:
    """Full-width gemma-7b through Engine; returns the kernels' launch counts."""
    return _serve_lm(gpu, LM_ARCH, "lm")


def phase_moe_serving(gpu: str) -> dict:
    """Full-width deepseek-v2-lite-16b (MLA, 64 routed experts) through
    Engine; returns the kernels' launch counts and the serving profile."""
    return _serve_lm(gpu, MOE_ARCH, "moe")


def phase_recurrent_serving(gpu: str) -> dict:
    """Full-width mamba2-370m (48 SSD layers) and recurrentgemma-2b (RG-LRU
    and local attention, with a windowed prefill and a decode across the
    ring's wrap) through Engine; returns each one's launch counts and
    serving profile."""
    # mamba2's 48 bf16 layers carry the kernels' rounding flips past the
    # dense gate (3.1-3.9% of max|ref|, where float32 activations differ by
    # 4.5e-6-5.8e-6): its bf16 logits are held at the reference's own
    # kernel-vs-plain gap at that depth, and its float32 run at the f32 gate
    return {SSM_ARCH: _serve_lm(gpu, SSM_ARCH, "recurrent", max_len=RECURRENT_MAX_LEN,
                                bf16_gate=MAMBA2_BF16_LOGIT_GATE, f32_check=True),
            HYBRID_ARCH: _serve_lm(gpu, HYBRID_ARCH, "recurrent", HYBRID_EXTRA, RECURRENT_MAX_LEN,
                                   f32_check=True)}


# whisper-tiny's served run: a batch of stub frames (the conv frontend's
# output), short prompts, greedy decode steps; and one teacher-forced loss
WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS, WHISPER_LOSS_TOKENS = (
    "whisper-tiny", 4, 4, 60, 448)


def phase_whisper_serving(gpu: str) -> dict:
    """Full-width whisper-tiny through its entry points: a batch of stub
    frames encoded, prompts prefilled, greedy decode steps; exact flash
    launches (the encoder's layers and every cross-attention) and no
    RMSNorm; the prefill's and first decode step's logits through the
    kernels against the plain versions in bf16 and with f32 activations;
    then one teacher-forced ``whisper_loss`` likewise. Returns the launch
    counts and the serving profile."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import (init_whisper_params, whisper_decode_step, whisper_loss,
                                    whisper_prefill)
    from repro_torch.models.whisper import decode_train, encode, flash_per_loss, flash_per_prefill

    tag = "whisper"
    cfg = get_arch(WHISPER_ARCH)
    b, s, steps, f = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS, cfg.encoder.frames
    print(f"[{tag}] {cfg.name} at full width: {cfg.encoder.n_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.kv_heads} kv heads "
          f"x {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {f} stub frames; random weights "
          f"(seed 0)")
    dev = torch.device("cuda")
    _free_cuda()
    params = init_whisper_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                 device=dev, serving=True)
    held = sum(t.numel() * t.element_size() for t in _leaves(params))
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((b, f, cfg.d_model), generator=gen, device=dev)
    prompt = torch.randint(1, cfg.vocab, (b, s), generator=gen, device=dev)
    max_len = s + steps
    with torch.inference_mode():
        # warm up (cuBLAS handles, the allocator) outside the counted run
        logits, cache = whisper_prefill(params, prompt, frames, cfg, max_len=max_len)
        whisper_decode_step(params, torch.argmax(logits, -1)[:, None], cache, s, cfg)
        enc_ms = cuda_ms(lambda: encode(params, frames, cfg), iters=5, warmup=1)
        enc_busy_ms, enc_busy_by = device_ms(lambda: encode(params, frames, cfg), n=5)
        del logits, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        logits, cache = whisper_prefill(params, prompt, frames, cfg, max_len=max_len)
        tok = torch.argmax(logits, -1)[:, None]
        out = [tok.flatten().tolist()]
        prefill_s = time.perf_counter() - t0
        decode_s = []
        for i in range(steps):
            t = time.perf_counter()
            logits, cache = whisper_decode_step(params, tok, cache, s + i, cfg)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok.flatten().tolist())
            decode_s.append(time.perf_counter() - t)
        dt = time.perf_counter() - t0
        launches = {"rmsnorm": rmsnorm_cuda.launches, "flash": flash_attention_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    cache_gb = sum(t.numel() * t.element_size() for t in _leaves(cache)) / 1e9
    tokens = b * (steps + 1)
    if not _finite(logits) or any(not 0 <= t < cfg.vocab for row in out for t in row):
        raise SystemExit(f"[{tag}] non-finite logits or a token id out of range")
    print(f"[{tag}] batch {b}, {s}-token prompts, {steps} greedy decode steps, max_len {max_len}: "
          f"encoder {enc_ms:.3f} ms (CUDA events, median of 5; its kernels busy the device "
          f"{enc_busy_ms:.3f} ms, {enc_busy_by}); prefill {prefill_s * 1e3:.2f} ms; "
          f"decode step mean {np.mean(decode_s) * 1e3:.2f} ms, median "
          f"{np.median(decode_s) * 1e3:.2f} ms; {tokens} tokens in {dt:.3f}s: {tokens / dt:.1f} "
          f"tok/s; weights {held / 1e9:.3f} GB, cache {cache_gb:.3f} GB; max_memory_allocated "
          f"{peak:.2f} GiB; {gpu}")
    print(f"[{tag}]   row 0: prompt {prompt[0].tolist()} -> {[r[0] for r in out[:16]]}...")
    want = {"rmsnorm": 0, "flash": flash_per_prefill(cfg) + steps * cfg.n_layers}
    print(f"[{tag}] launches: flash {launches['flash']} (want {flash_per_prefill(cfg)} a prefill + "
          f"{steps} steps x {cfg.n_layers} = {want['flash']}), rmsnorm {launches['rmsnorm']} "
          f"(want 0: LayerNorms); {gpu}")
    if launches != want:
        raise SystemExit(f"[{tag}] the served run did not launch the kernels as expected")
    del cache, logits

    # the prefill's last-token logits and the first decode step's (fed the
    # served run's first token) through the kernels and the plain versions,
    # in bf16 and with f32 activations on the same bf16-valued weights. The
    # caches are bf16 whatever the activation dtype (the reference's), and
    # two prefills whose k/v differ by f32 rounding round some of them to
    # neighbouring bf16 values: the plain decode step is held on a copy of
    # the kernel run's cache ("same cache"), which holds the decode step's
    # arithmetic, and on its own ("own cache"), held at the bf16 gate in
    # bf16 and printed with f32 activations
    rel = {}
    first = torch.tensor(out[0], device=dev)[:, None]
    for run_cfg, gate in ((cfg, LM_LOGIT_GATE),
                          (dataclasses.replace(cfg, dtype="float32"), LM_F32_LOGIT_GATE)):
        res = {}
        for kind in ("kernels", "plain"):
            with torch.inference_mode(), \
                    (plain_kernels() if kind == "plain" else contextlib.nullcontext()):
                before = flash_attention_cuda.launches
                logits, cache = whisper_prefill(params, prompt, frames, run_cfg, max_len=s + 1)
                if kind == "kernels":
                    shared = {"self": {k: v.clone() for k, v in cache["self"].items()},
                              "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
                step, _ = whisper_decode_step(params, first, cache, s, run_cfg)
                steps_out = [step.float()]
                if kind == "plain":
                    same, _ = whisper_decode_step(params, first, shared, s, run_cfg)
                    steps_out.append(same.float())
                moved = flash_attention_cuda.launches - before
                if moved != (flash_per_prefill(cfg) + cfg.n_layers if kind == "kernels" else 0):
                    raise SystemExit(f"[{tag}] the {kind} check launched flash {moved} times")
                res[kind] = (logits.float(), *steps_out)
                del cache
        del shared
        kernels, plain = res["kernels"], res["plain"]
        for got, ref, what in ((kernels[0], plain[0], "prefill last-token logits"),
                               (kernels[1], plain[2], "first decode step logits, same cache")):
            rel[f"{what} {run_cfg.dtype}"] = _logit_pair(
                tag, f"{what}, {run_cfg.dtype} activations", got, ref, gate)
        what = "first decode step logits, own cache"
        if run_cfg is cfg:
            rel[f"{what} {run_cfg.dtype}"] = _logit_pair(
                tag, f"{what}, {run_cfg.dtype} activations", kernels[1], plain[1], gate)
        else:
            err = float((kernels[1] - plain[1]).abs().max()) / float(plain[1].abs().max())
            rel[f"{what} {run_cfg.dtype}"] = err
            print(f"[{tag}] {what}, {run_cfg.dtype} activations (bf16 caches rounded apart; not "
                  f"gated): max|d| / max|ref| = {err:.3e}")
        greedy = [torch.argmax(res[k][0], -1).tolist() for k in ("kernels", "plain")]
        print(f"[{tag}] prefill greedy tokens, {run_cfg.dtype}: kernels {greedy[0]}, plain "
              f"{greedy[1]}, served {out[0]}")
        if run_cfg is cfg and not greedy[0] == greedy[1] == out[0]:
            raise SystemExit(f"[{tag}] the bf16 prefill's greedy tokens differ between the runs")

    # one teacher-forced loss forward, its own launches counted and its
    # scalar printed (with random weights it sits near ln(vocab) whatever
    # the attention does, so it is not what is gated); decode_train's final
    # hidden states over all 448 positions, through the kernels and the
    # plain versions, are held at the logit gates
    teacher = torch.randint(1, cfg.vocab, (b, WHISPER_LOSS_TOKENS + 1), generator=gen, device=dev)
    batch = {"frames": frames, "tokens": teacher[:, :-1], "targets": teacher[:, 1:]}
    losses = {}
    with torch.inference_mode():
        for run_cfg, gate in ((cfg, LM_LOGIT_GATE),
                              (dataclasses.replace(cfg, dtype="float32"), LM_F32_LOGIT_GATE)):
            rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
            t = time.perf_counter()
            loss, _ = whisper_loss(params, batch, run_cfg)
            value = float(loss)  # waits for the device
            loss_ms = (time.perf_counter() - t) * 1e3
            loss_launches = {"rmsnorm": rmsnorm_cuda.launches, "flash": flash_attention_cuda.launches}
            if loss_launches != {"rmsnorm": 0, "flash": flash_per_loss(cfg)}:
                raise SystemExit(f"[{tag}] whisper_loss launched {loss_launches}, want flash "
                                 f"{flash_per_loss(cfg)} and no rmsnorm")
            with plain_kernels():
                ref, _ = whisper_loss(params, batch, run_cfg)
            losses[run_cfg.dtype] = (value, float(ref), loss_ms)
            print(f"[{tag}] whisper_loss over {b} x {WHISPER_LOSS_TOKENS} teacher-forced tokens, "
                  f"{run_cfg.dtype} activations: {value:.6f} (plain {float(ref):.6f}, ln(vocab) "
                  f"{np.log(cfg.vocab):.6f}) in {loss_ms:.1f} ms; launches {loss_launches}; {gpu}")
            hidden = {}
            for kind in ("kernels", "plain"):
                with plain_kernels() if kind == "plain" else contextlib.nullcontext():
                    before = flash_attention_cuda.launches
                    enc_out = encode(params, frames, run_cfg)
                    hidden[kind] = decode_train(params, batch["tokens"], enc_out, run_cfg).float()
                    moved = flash_attention_cuda.launches - before
                    if moved != (flash_per_loss(cfg) if kind == "kernels" else 0):
                        raise SystemExit(f"[{tag}] the {kind} decode_train launched flash {moved} "
                                         f"times")
                    del enc_out
            rel[f"decode_train hidden {run_cfg.dtype}"] = _logit_pair(
                tag, f"decode_train final hidden states [{b}, {WHISPER_LOSS_TOKENS}, "
                f"{cfg.d_model}], {run_cfg.dtype} activations", hidden["kernels"],
                hidden["plain"], gate)
            del hidden
    del params
    _free_cuda()
    stats = {"encoder_ms": enc_ms, "encoder_busy_ms": enc_busy_ms,
             "encoder_busy_timed_by": enc_busy_by, "prefill_ms": prefill_s * 1e3,
             "decode_ms_mean": float(np.mean(decode_s) * 1e3),
             "decode_ms_median": float(np.median(decode_s) * 1e3), "tokens": tokens, "seconds": dt,
             "tok_per_s": tokens / dt, "peak_gib": peak, "held_weights_gb": held / 1e9,
             "cache_gb": cache_gb, "loss": losses, "logit_rel_err": rel}
    return {**launches, "loss_flash": loss_launches["flash"], "stats": stats}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _lm_cli_run(arch: str) -> subprocess.CompletedProcess:
    """The LM serving CLI (``reduced(arch)``) on the card, as a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch]
    return subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)


def _lm_cli_check(gpu: str, arch: str, out: subprocess.CompletedProcess) -> dict:
    """Print a CLI run's output and check its launch counts; returns them."""
    print("\n".join("[lm_cli] " + line for line in out.stdout.strip().splitlines()))
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"[lm_cli] serve --arch {arch} exited {out.returncode}")
    m = re.search(r"kernel launches: rmsnorm (\d+) over (\d+) prefills \+ (\d+) decode steps "
                  r"x (\d+) norms; flash_attention (\d+) over (\d+) prefills x (\d+) layers",
                  out.stdout)
    if m is None:
        raise SystemExit(f"[lm_cli] serve --arch {arch} printed no kernel launch counts")
    rms, prefills, steps, norms, flash, prefills2, n_layers = map(int, m.groups())
    if prefills == 0 or rms != norms * (prefills + steps) or flash != n_layers * prefills2 \
            or prefills2 != prefills:
        raise SystemExit(f"[lm_cli] {arch}: launches rmsnorm {rms}, flash {flash} do not match "
                         f"{prefills} prefills + {steps} decode steps")
    print(f"[lm_cli] {arch}: launches rmsnorm {rms}, flash {flash}; {gpu}")
    return {"rmsnorm": rms, "flash": flash}


def phase_lm_cli(gpu: str) -> dict:
    """The LM serving CLI on the card for reduced gemma-7b and both reduced
    deepseek configs (the reduced MLA config's head dim 24 runs the flash
    kernel padded to 32), the three processes at once (each counts its own
    launches; they share the card); returns the counts by arch."""
    _free_cuda()
    with ThreadPoolExecutor(max_workers=len(CLI_ARCHS)) as pool:
        runs = list(pool.map(_lm_cli_run, CLI_ARCHS))
    return {arch: _lm_cli_check(gpu, arch, out) for arch, out in zip(CLI_ARCHS, runs)}


# ---------------------------------------------------------------------------
# Phase lm train: LM training at full width (gemma-7b, depth cut), the
# gradient gate of the two LM kernels, and the training CLI for --mode lm.
# ---------------------------------------------------------------------------

# gemma-7b's training shape on one card (configs/gemma_7b.py ONE_CARD_TRAIN_*:
# 4 of its 28 layers, batch 2 of 1024 tokens as 2 micro-batches, remat on),
# bf16 activations, 3 AdamW steps
LM_TRAIN_STEPS = 3
# every leaf's gradient through the kernels against the plain versions',
# float32 activations: within this share of that leaf's max|ref|
LM_GRAD_GATE = 1e-4
# the reference's test_arch_smoke: the first loss within this of ln(vocab)
LM_INIT_LOSS_SLACK = 1.5
WHISPER_TRAIN_BATCH = 4
LM_TRAIN_CLI_STEPS, LM_TRAIN_CLI_FAULT = 4, 2
# --devices 2 against one rank: bf16 activations, each rank's products half
# the rows, so sums round differently (tests/test_torch_train.py: 1e-3)
LM_TRAIN_CLI_DEVICES_RTOL = 1e-3


def _tree_pairs(ref, got, prefix=""):
    """(name, ref leaf, got leaf or None) over ``ref``'s tree (dicts, lists,
    None an empty subtree)."""
    if ref is None:
        return []
    if isinstance(ref, dict):
        return [t for k in ref for t in _tree_pairs(ref[k], None if got is None else got.get(k),
                                                    f"{prefix}.{k}")]
    if isinstance(ref, list):
        return [t for i, r in enumerate(ref)
                for t in _tree_pairs(r, None if got is None else got[i], f"{prefix}.{i}")]
    return [(prefix.lstrip("."), ref, got)]


def _grad_gate_faults(got, ref) -> tuple:
    """(faults, worst): the leaves of ``got`` that miss ``ref`` by more
    than ``LM_GRAD_GATE`` x max|ref| of the leaf (of the query bias's for
    a key bias), are all zeros, not finite, or missing where ``ref`` is not
    zero; and the largest max|d| / max|ref| of the leaves that pass."""
    faults, worst = [], (0.0, "")
    pairs = _tree_pairs(ref, got)
    scales = {name: float(r.abs().max()) for name, r, _ in pairs}
    for name, r, g in pairs:
        # a key bias shifts every logit of a query by the same q . bk, which
        # the softmax cancels: its exact gradient is zero and both runs' are
        # rounding noise, held at the scale of the query bias's gradient
        scale = scales[name[:-2] + "bq"] if name.endswith(".bk") else scales[name]
        if g is None:
            if scale > 0:
                faults.append(f"{name}: no gradient (max|ref| {scale:.3e})")
            continue
        if not _finite(g) or float(g.abs().max()) == 0.0:
            faults.append(f"{name}: {'all zeros' if _finite(g) else 'not finite'}")
            continue
        err = float((g.float() - r.float()).abs().max())
        if not err <= LM_GRAD_GATE * scale:
            faults.append(f"{name}: max|d| {err:.3e} > {LM_GRAD_GATE} x max|ref| {scale:.3e}")
        else:
            worst = max(worst, (err / scale if scale else 0.0, name))
    return faults, worst


@contextlib.contextmanager
def cut_kernels():
    """Within the block the two LM kernels' outputs leave the graph, as the
    wrappers returned them before they were differentiable: the gradient
    gate must refuse what such a run computes."""
    import repro_torch.kernels.flash_attention as flash_pkg
    import repro_torch.kernels.rmsnorm as rms_pkg

    saved = rms_pkg.rmsnorm, flash_pkg.flash_attention
    rms_pkg.rmsnorm = lambda *a, **k: saved[0](*a, **k).detach()
    flash_pkg.flash_attention = lambda *a, **k: saved[1](*a, **k).detach()
    try:
        yield
    finally:
        rms_pkg.rmsnorm, flash_pkg.flash_attention = saved


def _kernel_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    return {"rmsnorm": rmsnorm_cuda.launches, "flash": flash_attention_cuda.launches}


def _zero_kernel_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    rmsnorm_cuda.launches = flash_attention_cuda.launches = 0


def _gated_grads(tag, loss_fn, params, batch, want: dict, gpu: str) -> float:
    """The gradient gate: ``loss_fn``'s gradients of every leaf through the
    kernels (whose launches must be ``want``) against the same through the
    plain versions, then a run with the kernels' outputs cut from the
    graph, which the gate must refuse. Returns the worst passing leaf's
    max|d| / max|ref|."""
    import torch

    from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree

    grads = {}
    for name, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
        grads[name] = zeros_like_tree(params)
        _zero_kernel_counts()
        t0 = time.perf_counter()
        with ctx():
            loss, _ = accumulate_grads(loss_fn, params, batch, grads[name])
        torch.cuda.synchronize()
        launched = _kernel_counts()
        print(f"[{tag}] forward + backward through the {name}: loss {float(loss):.6f}, "
              f"{time.perf_counter() - t0:.3f}s, launches {launched}; {gpu}")
        if name == "kernels" and launched != want:
            raise SystemExit(f"[{tag}] launches {launched}, want {want}")
        if name == "plain" and any(launched.values()):
            raise SystemExit(f"[{tag}] the plain run launched kernels: {launched}")
    faults, worst = _grad_gate_faults(grads.pop("kernels"), grads["plain"])
    if faults:
        raise SystemExit(f"[{tag}] gradient gate: " + "; ".join(faults[:8]))
    print(f"[{tag}] gradient gate passed: every leaf within {LM_GRAD_GATE} x its max|ref| "
          f"(worst {worst[0]:.3e}, {worst[1]}), none zero or missing")
    cut = zeros_like_tree(params)
    with cut_kernels():
        accumulate_grads(loss_fn, params, batch, cut)
    faults, _ = _grad_gate_faults(cut, grads["plain"])
    print(f"[{tag}] the gate on a run with the kernels' outputs cut from the graph: "
          f"{len(faults)} leaves refused, e.g. {faults[:3]}")
    if not faults:
        raise SystemExit(f"[{tag}] the gradient gate did not refuse a cut graph")
    del grads, cut
    _free_cuda()
    return worst[0]


def _backward_times(gpu: str, seq: int) -> dict:
    """Device time of the two kernels' forward and of their backward (the
    plain versions' gradient, recomputed from the saved inputs) at the
    training shapes: gemma-7b's norm rows and attention layer of one
    micro-batch, and whisper-tiny's encoder attention."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(shape, grad=True):
        t = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        return t.requires_grad_(grad)

    out = {}
    x, w = randn((seq, 3072)), torch.ones(3072, device=dev, requires_grad=True)
    y = rmsnorm(x, w)
    dy = torch.randn_like(y)
    with torch.no_grad():
        fwd, fwd_by = device_ms(lambda: rmsnorm(x, w))
    bwd, bwd_by = device_ms(lambda: torch.autograd.grad(y, (x, w), dy, retain_graph=True))
    out["rmsnorm"] = {f"[{seq}, 3072] bf16": {
        "forward_ms": fwd, "backward_ms": bwd, "timed_by": [fwd_by, bwd_by]}}
    out["flash"] = {}
    for name, shape, causal in ((f"gemma-7b (1,16,16,{seq},256) causal", (1, 16, seq, 256), True),
                                ("whisper-tiny encoder (4,6,6,1500,64)", (4, 6, 1500, 64), False)):
        q, k, v = (randn(shape) for _ in range(3))
        o = flash_attention(q, k, v, causal=causal)
        do = torch.randn_like(o)
        with torch.no_grad():
            fwd, fwd_by = device_ms(lambda: flash_attention(q, k, v, causal=causal))
        bwd, bwd_by = device_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True), n=10)
        out["flash"][name] = {"forward_ms": fwd, "backward_ms": bwd, "timed_by": [fwd_by, bwd_by]}
        del q, k, v, o, do
    for kernel, shapes in out.items():
        for shape, t in shapes.items():
            print(f"[lm train] {kernel} {shape}: forward (the kernel) {t['forward_ms']:.4f} ms, "
                  f"backward (the plain version's gradient) {t['backward_ms']:.4f} ms, device time "
                  f"({'/'.join(t['timed_by'])}); {gpu}")
    _free_cuda()
    return out


def _lm_train_cli_run(flags: list) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm", *flags]
    return subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)


def _lm_train_cli_check(tag: str, out: subprocess.CompletedProcess, want: list, rtol: float,
                        gpu: str) -> dict:
    """A ``--mode lm`` run's lines checked: its exit, the losses against
    ``want`` (an uninterrupted run's) within ``rtol`` (0: bitwise), its
    launches against its executed steps; returns the launches."""
    print("\n".join(f"[lm_train_cli] {tag}: " + line for line in out.stdout.strip().splitlines()))
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"[lm_train_cli] {tag} exited {out.returncode}")
    losses = json.loads(re.search(r"^losses: (.*)$", out.stdout, re.M).group(1))
    m = re.search(r"kernel launches: rmsnorm (\d+), flash (\d+) over (\d+) train steps x (\d+) "
                  r"micro-batches \(a pass: rmsnorm (\d+), flash (\d+)\)", out.stdout)
    if m is None:
        raise SystemExit(f"[lm_train_cli] {tag} printed no kernel launch counts")
    rms, flash, steps, accum, per_rms, per_flash = map(int, m.groups())
    if steps == 0 or rms != steps * accum * per_rms or flash != steps * accum * per_flash:
        raise SystemExit(f"[lm_train_cli] {tag}: launches rmsnorm {rms}, flash {flash} do not "
                         f"match {steps} steps x {accum} micro-batches")
    a, b = np.asarray(losses), np.asarray(want)
    rel = float(np.max(np.abs(a - b) / np.abs(b))) if a.shape == b.shape else float("inf")
    same = "bitwise" if losses == want else f"max relative difference {rel:.3e}"
    print(f"[lm_train_cli] {tag}: losses vs the uninterrupted run's: {same}; launches rmsnorm "
          f"{rms}, flash {flash} over {steps} executed steps; {gpu}")
    if not np.isfinite(a).all() or not rel <= rtol:
        raise SystemExit(f"[lm_train_cli] {tag}: losses {losses} != uninterrupted {want}")
    return {"rmsnorm": rms, "flash": flash, "steps": steps, "losses_bitwise": losses == want,
            "losses_max_rel": rel}


def _lm_train_cli(gpu: str) -> dict:
    """``train --mode lm`` on the card for each of ``CLI_ARCHS`` through a
    fault (restored from its checkpoint), against an uninterrupted run of
    the entry point in this process, and for gemma-7b on 2 ranks."""
    import io
    import tempfile

    from repro_torch.launch import train as train_cli

    base = ["--steps", str(LM_TRAIN_CLI_STEPS), "--save-every", "2"]
    with tempfile.TemporaryDirectory() as d:
        jobs = {arch: [*base, "--arch", arch, "--inject-fault", str(LM_TRAIN_CLI_FAULT),
                       "--ckpt-dir", os.path.join(d, arch)] for arch in CLI_ARCHS}
        jobs["devices2"] = [*base, "--arch", LM_ARCH, "--devices", "2",
                            "--ckpt-dir", os.path.join(d, "devices2")]
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            runs = {tag: pool.submit(_lm_train_cli_run, flags) for tag, flags in jobs.items()}
            want = {}
            for arch in CLI_ARCHS:
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    train_cli.main(["--mode", "lm", *base, "--arch", arch,
                                    "--ckpt-dir", os.path.join(d, f"{arch}-plain")])
                want[arch] = json.loads(re.search(r"^losses: (.*)$", text.getvalue(), re.M).group(1))
            runs = {tag: f.result() for tag, f in runs.items()}
    out = {}
    for arch in CLI_ARCHS:
        if "failures=1 restores=1" not in runs[arch].stdout:
            print(runs[arch].stdout, runs[arch].stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"[lm_train_cli] {arch}: the fault was not restored from a checkpoint")
        out[arch] = _lm_train_cli_check(arch, runs[arch], want[arch], 1e-6, gpu)
    out["devices2"] = _lm_train_cli_check(f"{LM_ARCH} --devices 2", runs["devices2"], want[LM_ARCH],
                                          LM_TRAIN_CLI_DEVICES_RTOL, gpu)
    return out


def phase_lm_train(gpu: str) -> dict:
    """gemma-7b training at full width on one card: the gradient gate of
    the kernels against the plain versions at f32 activations (one
    micro-batch, every leaf), then ``LM_TRAIN_STEPS`` AdamW steps in bf16
    (batch 2 as 2 micro-batches, remat on) with exact launches; the same
    gate for ``whisper_loss`` on whisper-tiny at full width; the kernels'
    backward timed beside their forward; then the training CLI. Returns
    the launch counts by path and the measurements."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models import init_lm_params, init_whisper_params, lm_loss, whisper_loss
    from repro_torch.models.transformer import train_launches
    from repro_torch.models.whisper import flash_per_loss
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, warmup_cosine
    from repro_torch.train.train_loop import make_train_step

    from repro_torch.configs.gemma_7b import (
        ONE_CARD_TRAIN_ACCUM as LM_TRAIN_ACCUM,
        ONE_CARD_TRAIN_BATCH as LM_TRAIN_BATCH,
        ONE_CARD_TRAIN_LAYERS as LM_TRAIN_LAYERS,
        ONE_CARD_TRAIN_SEQ as LM_TRAIN_SEQ,
    )

    tag = "lm train"
    full = get_arch(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    state_gb = full.approx_params() * 16 / 1e9
    print(f"reduced: {LM_ARCH} layers {full.n_layers} -> {LM_TRAIN_LAYERS} (training state of "
          f"{full.n_layers} layers is {full.approx_params() / 1e9:.2f} B params x 16 B = "
          f"{state_gb:.0f} GB)")
    print(f"[{tag}] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim_}, d_ff "
          f"{cfg.d_ff} ({cfg.mlp_act}), vocab {cfg.vocab}, {LM_TRAIN_LAYERS} layers: "
          f"{cfg.approx_params() / 1e9:.3f} B params; batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens "
          f"as {LM_TRAIN_ACCUM} micro-batches, remat on, bf16 activations, f32 masters")
    dev = torch.device("cuda")
    _free_cuda()
    params = init_lm_params(cfg, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    data = SyntheticTokens(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=0)

    def on_card(batch):
        return {k: torch.from_numpy(v).to(dev, torch.long) for k, v in batch.items()}

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    micro = {k: v[:1] for k, v in on_card(data.batch(0)).items()}
    worst = {"lm": _gated_grads(f"{tag} f32 grad", lambda p, b: lm_loss(p, b, cfg32), params, micro,
                                train_launches(cfg32, LM_TRAIN_SEQ), gpu)}

    step = make_train_step(lambda p, b: lm_loss(p, b, cfg),
                           AdamWConfig(lr=warmup_cosine(1e-4, 10, LM_TRAIN_STEPS)),
                           grad_accum=LM_TRAIN_ACCUM)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    times, metrics = [], []
    for i in range(LM_TRAIN_STEPS):
        batch = on_card(data.batch(i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # params, their gradients and both moments, all f32
    held = 4 * sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    for i, (t, m) in enumerate(zip(times, metrics)):
        print(f"[{tag}] step {i}: loss {m['loss']:.6f} (xent {m['xent']:.6f}) grad_norm "
              f"{m['grad_norm']:.4e} lr {m['lr']:.3e} in {t * 1e3:.1f} ms")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    step_ms = float(np.mean(times[1:]) * 1e3)
    print(f"[{tag}] step {step_ms:.1f} ms after the first ({times[0] * 1e3:.1f} ms), "
          f"{tokens / (step_ms / 1e3):.0f} tokens/s; peak {peak:.2f} GiB (max_memory_allocated; "
          f"params, gradients and moments {held:.1f} GB); {gpu}")
    ln_v = math.log(cfg.vocab)
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        raise SystemExit(f"[{tag}] a loss or grad norm is not finite")
    if not abs(metrics[0]["loss"] - ln_v) <= LM_INIT_LOSS_SLACK:
        raise SystemExit(f"[{tag}] init loss {metrics[0]['loss']:.4f} not within "
                         f"{LM_INIT_LOSS_SLACK} of ln({cfg.vocab}) = {ln_v:.4f}")
    per = train_launches(cfg, LM_TRAIN_SEQ)
    want = {k: LM_TRAIN_STEPS * LM_TRAIN_ACCUM * v for k, v in per.items()}
    print(f"[{tag}] launches over {LM_TRAIN_STEPS} steps: {launches} (want {want}: a pass "
          f"{per}, each layer's kernels twice with remat's recompute, the final norm once)")
    if launches != want:
        raise SystemExit(f"[{tag}] the training steps did not launch the kernels as expected")
    del params, opt, step
    _free_cuda()

    wcfg = dataclasses.replace(get_arch(WHISPER_ARCH), dtype="float32")
    wparams = init_whisper_params(wcfg, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    teacher = torch.randint(1, wcfg.vocab, (WHISPER_TRAIN_BATCH, WHISPER_LOSS_TOKENS + 1),
                            generator=gen, device=dev)
    wbatch = {"frames": torch.randn((WHISPER_TRAIN_BATCH, wcfg.encoder.frames, wcfg.d_model),
                                    generator=gen, device=dev),
              "tokens": teacher[:, :-1], "targets": teacher[:, 1:]}
    print(f"[{tag}] {wcfg.name} at full width, f32 activations: whisper_loss over "
          f"{WHISPER_TRAIN_BATCH} x {wcfg.encoder.frames} frames and {WHISPER_LOSS_TOKENS} tokens")
    whisper_want = {"rmsnorm": 0, "flash": flash_per_loss(wcfg)}
    worst["whisper"] = _gated_grads(f"{tag} whisper f32 grad", lambda p, b: whisper_loss(p, b, wcfg),
                                    wparams, wbatch, whisper_want, gpu)
    del wparams, wbatch
    _free_cuda()

    backward = _backward_times(gpu, LM_TRAIN_SEQ)
    cli = _lm_train_cli(gpu)
    return {"launches": launches, "whisper_launches": whisper_want, "cli": cli,
            "backward": backward, "stats": {
                "step_ms": step_ms, "first_step_ms": times[0] * 1e3, "tokens_per_s": tokens / (step_ms / 1e3),
                "peak_gib": peak, "held_gb": held, "losses": [m["loss"] for m in metrics],
                "grad_gate_worst": worst, "layers": LM_TRAIN_LAYERS}}


# ---------------------------------------------------------------------------
# Phase `dist lm`: the distributed LM's forward, loss and gradient on 4 gloo
# ranks sharing the card (tensor parallelism over a model group, data
# parallelism over a data group, the MoE's all-to-all, Ulysses), against
# serial runs on the card; a timed bf16 training step; the CLI on 2 ranks.
# ---------------------------------------------------------------------------

# the archs of the reference's dist_lm_loss_matches_local at full width,
# with their depth cut: chatglm3-6b 2 of 28 layers; deepseek-moe-16b and
# deepseek-v2-lite-16b (MLA) their dense layer 0 and 1 MoE layer;
# mamba2-370m (its SSD mixer over the model group's heads) 2 of 48 layers;
# recurrentgemma-2b (the RG-LRU replicated, its local attention and MLPs
# tensor-parallel) one superblock, 3 of 26 layers
DIST_LM_ARCHS = {"chatglm3-6b": 2, "deepseek-moe-16b": 2, "deepseek-v2-lite-16b": 2,
                 SSM_ARCH: 2, HYBRID_ARCH: 3}
# the archs whose bf16 training step is timed on (1 x 4)
DIST_LM_STEP_ARCHS = ("chatglm3-6b", "deepseek-v2-lite-16b", SSM_ARCH, HYBRID_ARCH)
# the gate runs with a sum over the model group cut, which the gate must
# refuse: the kernels' outputs cut from the graph, and mamba2's w_B used on
# each rank's heads without ``copy_to`` (its gradient a rank's part)
DIST_LM_CUTS = {("chatglm3-6b", "1x4"): "kernels", (SSM_ARCH, "1x4"): "w_B"}
DIST_LM_BATCH, DIST_LM_SEQ = 2, 1024
# (name, ranks to a model group, seq_shard): the gates run on both
DIST_LM_LAYOUTS = (("1x4", 4, True), ("2x2", 2, False))
DIST_LM_SEED = 17
DIST_LM_LOSS_RTOL = 3e-3   # tests/distributed_checks.py: dist_lm_loss_matches_local
DIST_LM_GRAD_RTOL = 5e-3   # with an atol of DIST_GRAD_LEAF_ATOL x the leaf's max|ref|
# Ulysses over chatglm3-6b's attention heads (32 q, 2 kv, head dim 128) at
# this batch and sequence, through the flash kernel on every rank
DIST_LM_ULYSSES = (1, 4096)
# the bf16 training steps timed on (1 x 4) with seq_shard (the first
# warms up and is not counted; cut from 3 for the script's time), then one
# step with the collectives timed
DIST_LM_STEPS = 2
DIST_LM_CLI_STEPS, DIST_LM_CLI_FAULT, DIST_LM_CLI_RTOL = 4, 2, 1e-3


def _kept_layers(cfg) -> str:
    """The layers a depth-cut config keeps, in words."""
    if cfg.moe:
        return "layer 0 (dense) and 1 MoE layer"
    if cfg.family == "hybrid":
        return f"{cfg.n_layers // len(cfg.pattern)} superblock ({', '.join(cfg.pattern)})"
    return f"{cfg.n_layers} layers"


def _dist_lm_cfg(arch: str, dtype: str):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch), n_layers=DIST_LM_ARCHS[arch], dtype=dtype)


def _dist_lm_params(cfg, device):
    import torch

    from repro_torch.models import init_lm_params

    return init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(DIST_LM_SEED),
                          device=device)


def _dist_lm_batch(cfg, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(DIST_LM_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (DIST_LM_BATCH, DIST_LM_SEQ + 1), generator=gen,
                         device=device)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@contextlib.contextmanager
def per_shard_moe(shards: tuple, recorded: dict, drops: list):
    """Within the block the serial MoE layer routes as the expert-parallel
    path does on a (data x model) = ``shards`` layout: each shard's tokens
    (its rows, its slice of the sequence) routed on their own with that
    shard's capacity (``_capacity`` of its token count), the experts all on
    this device, the load-balance loss from the statistics of every shard.
    Each shard's routes are appended to ``recorded[(d, m)]``, the entries
    it drops (a device tensor) and routes to ``drops``. A dropless call and
    a sequence that the model shards do not divide go through unchanged, as
    the expert-parallel path leaves them to ``_moe_together``."""
    import torch

    from repro_torch.models import LOCAL
    from repro_torch.models import layers as layers_lib
    from repro_torch.models import moe as moe_lib

    saved = moe_lib.moe_apply
    dp, mp = shards

    def sharded(params, x, moe, policy=LOCAL, **kw):
        b, s, d = x.shape
        if kw.get("dropless") or s % mp:
            return saved(params, x, moe, policy, **kw)
        rows, stats = [], []
        for di, xr in enumerate(x.chunk(dp, 0)):
            pieces = []
            for mi, xs in enumerate(xr.chunk(mp, 1)):
                flat = xs.reshape(-1, d)
                t = flat.shape[0]
                topi, topv, probs = moe_lib._route(flat, params["router"], moe)
                recorded.setdefault((di, mi), []).append(topi)
                cap = moe_lib._capacity(t, moe)
                buf, e_flat, pos, keep = moe_lib._dispatch(flat, topi, cap, moe.n_experts)
                drops.append(((~keep).sum(), keep.numel()))
                y_buf = moe_lib._expert_ffn(buf, params["w_gate"], params["w_up"], params["w_down"])
                pieces.append(moe_lib._combine(y_buf, e_flat, pos, keep, topv, t, cap)
                              .reshape(xs.shape))
                stats.append(moe_lib._aux_stats(topi, probs, moe))
            rows.append(torch.cat(pieces, 1))
        y = torch.cat(rows, 0)
        aux = moe_lib._aux_from_stats(sum(st[0] for st in stats), sum(st[1] for st in stats),
                                      sum(st[2] for st in stats), moe)
        sh = params["shared"]
        y = y + layers_lib.glu_mlp(x, sh["w_gate"], sh["w_up"], sh["w_down"], act="swiglu")
        return y, aux * moe.aux_coef

    moe_lib.moe_apply = sharded
    try:
        yield
    finally:
        moe_lib.moe_apply = saved


def _dist_lm_serial(arch: str, shards, gpu: str, dev) -> dict:
    """The serial f32 loss and gradient of ``arch`` on the card through
    the kernels (remat off, as the gate's distributed run), the MoE layers
    routing per shard of ``shards`` (``per_shard_moe``); returns them with
    each leaf's max|ref| and the shards' routes."""
    import torch

    from repro_torch.models import ParallelPolicy, lm_loss
    from repro_torch.models.transformer import flash_per_prefill, norms_per_forward
    from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree

    cfg = _dist_lm_cfg(arch, "float32")
    params = _dist_lm_params(cfg, dev)
    batch = _dist_lm_batch(cfg, dev)
    grads = zeros_like_tree(params)
    recorded, drops = {}, []
    ctx = per_shard_moe(shards, recorded, drops) if cfg.moe else contextlib.nullcontext()
    _zero_kernel_counts()
    t0 = time.perf_counter()
    with ctx:
        loss, metrics = accumulate_grads(
            lambda p, b: lm_loss(p, b, cfg, ParallelPolicy(remat=False)), params, batch, grads)
    torch.cuda.synchronize()
    launched = _kernel_counts()
    want = {"rmsnorm": norms_per_forward(cfg), "flash": flash_per_prefill(cfg, DIST_LM_SEQ)}
    if launched != want:
        raise SystemExit(f"[dist lm] serial {arch}: launches {launched}, want {want}")
    dropped = sum(int(n) for n, _ in drops)
    routed = sum(e for _, e in drops)
    what = (f", MoE per {shards[0]} x {shards[1]} shard: {dropped} of {routed} entries dropped "
            f"({dropped / max(routed, 1):.2%})" if cfg.moe else "")
    print(f"[dist lm] serial {arch} f32 ({cfg.n_layers} layers, batch {DIST_LM_BATCH} x "
          f"{DIST_LM_SEQ}): loss {float(loss):.6f} (xent {float(metrics['xent']):.6f}, aux "
          f"{float(metrics['aux']):.3e}) in {time.perf_counter() - t0:.2f}s, launches "
          f"{launched}{what}; {gpu}")
    del params
    scale = {name: float(g.abs().max()) for name, g, _ in _tree_pairs(grads, None)}
    return {"loss": float(loss), "xent": float(metrics["xent"]), "grads": grads, "scale": scale,
            "routes": recorded, "drop_share": dropped / max(routed, 1)}


def _dist_lm_setup(world_size: int) -> dict:
    """A rank's start: the parent's float32 settings and the groups of the
    gate layouts."""
    import torch

    from repro_torch.launch.mesh import build_lm_groups

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return {name: build_lm_groups(world_size, p) for name, p, _ in DIST_LM_LAYOUTS}


def _shards_in_turns(draw, cfg, pol) -> dict:
    """This rank's shards (``shard_params``) of the whole tree ``draw()``
    makes. The ranks draw it in turns, so that one whole copy exists at a
    time."""
    import torch
    import torch.distributed as dist

    from repro_torch.models.transformer import shard_params

    local = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            local = shard_params(draw(), cfg, pol)
            torch.cuda.empty_cache()
        dist.barrier()
    return local


def _dist_lm_local(cfg, pol, device) -> dict:
    """This rank's shards of the seeded weights."""
    return _shards_in_turns(lambda: _dist_lm_params(cfg, device), cfg, pol)


def _dist_lm_leaf_gate(g, ref, spec, pol, scale) -> dict:
    """One leaf of this rank's reduced gradient against its slice of the
    serial one, at rtol ``DIST_LM_GRAD_RTOL`` and an atol of
    ``DIST_GRAD_LEAF_ATOL`` x the whole leaf's max|ref|; the same gate must
    refuse zeros and, for a split leaf, the next rank's slice."""
    import torch

    from repro_torch.core.partition import local_slice
    from repro_torch.models.policy import MODEL_AXIS

    tol = (DIST_LM_GRAD_RTOL, DIST_GRAD_LEAF_ATOL * scale)
    group = pol.model_group
    dim = spec.index(MODEL_AXIS) if MODEL_AXIS in spec and pol.model_size() > 1 else None
    want = ref if dim is None else local_slice(ref, dim, group)
    ok, max_d, _ = _close(g, want, tol)
    wrong = {"zeros": torch.zeros_like(g)}
    if dim is not None:
        n = want.shape[dim]
        wrong["neighbouring shard"] = ref.narrow(dim, (group.rank() + 1) % group.size() * n, n)
    passed_wrong = [what for what, t in wrong.items() if _close(t, want, tol)[0]]
    return {"ok": ok and _finite(g), "max_d": max_d, "max_ref": scale, "passed_wrong": passed_wrong}


@contextlib.contextmanager
def cut_w_b():
    """Within the block the SSD mixer takes w_B as a whole leaf without
    ``copy_to``: each rank's gradient of it stays the part its heads give,
    which the gradient gate must refuse."""
    import repro_torch.models.ssm as ssm_lib

    saved = ssm_lib.WHOLE_LEAVES
    ssm_lib.WHOLE_LEAVES = tuple(n for n in saved if n != "w_B")
    try:
        yield
    finally:
        ssm_lib.WHOLE_LEAVES = saved


def _dist_lm_gate(arch: str, pol, serial: dict, recorded, device, cut) -> dict:
    """One f32 forward + backward of ``lm_loss`` on this rank's shards and
    rows (remat off; the MoE routes replayed from the serial run's shard),
    its gradients reduced (``reduce_grads``, the LM's rule) and each leaf
    gated against the serial gradient; with ``cut`` ("kernels" or "w_B"),
    the same run with the kernels' outputs cut from the graph or with
    w_B's sum over the group cut (``cut_w_b``), which the gate must
    refuse."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.partition import local_slice
    from repro_torch.models import lm_loss
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.train_loop import accumulate_grads, reduce_grads, zeros_like_tree

    cfg = _dist_lm_cfg(arch, "float32")
    local = _dist_lm_local(cfg, pol, device)
    batch = {k: local_slice(v, 0, pol.data_group) for k, v in _dist_lm_batch(cfg, device).items()}
    layout = _dist_lm_layout(cfg, pol)
    specs = {name: spec for name, spec, _ in _tree_pairs(param_specs(cfg, pol), None)}
    refs = {name: ref for name, ref, _ in _tree_pairs(serial["grads"], None)}

    def run(ctx):
        grads = zeros_like_tree(local)
        _zero_kernel_counts()
        with ctx, (routes(recorded) if recorded is not None else contextlib.nullcontext()) as rt:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, metrics = accumulate_grads(lambda p, b: lm_loss(p, b, cfg, pol), local, batch,
                                             grads)
            torch.cuda.synchronize()
            fwd_bwd = time.perf_counter() - t0
        launched = _kernel_counts()
        reduce_grads(grads, layout)
        mean = torch.stack([loss, metrics["xent"]])
        dist.all_reduce(mean, group=pol.data_group)
        mean = (mean / pol.dp_size()).tolist()
        gates = {name: _dist_lm_leaf_gate(g, refs[name], specs[name], pol, serial["scale"][name])
                 for name, g, _ in _tree_pairs(grads, None)}
        flips = None if rt is None else {k: rt[k] for k in ("flips", "tied", "tokens")}
        return {"loss": mean[0], "xent": mean[1], "s": fwd_bwd, "launches": launched,
                "gates": gates, "flips": flips}

    out = run(contextlib.nullcontext())
    if cut:
        out["cut"] = run(cut_kernels() if cut == "kernels" else cut_w_b())["gates"]
        out["cut_kind"] = cut
    del local
    torch.cuda.empty_cache()
    return out


def _dist_lm_layout(cfg, pol):
    """The training state's layout over ``pol``'s groups: each leaf's
    partition by the specs, ZeRO-1 moments, the LM's gradient rule."""
    from repro_torch.common.tree import tree_map
    from repro_torch.models import init_lm_params
    from repro_torch.models.transformer import param_parts
    from repro_torch.train.optimizer import state_layout

    whole = init_lm_params(cfg, generator=None, device="meta")  # shapes only
    return state_layout(pol.mesh, param_parts(cfg, pol, whole),
                        tree_map(lambda p: tuple(p.shape), whole), grads_complete=True)


def _dist_lm_ulysses(group, job, device) -> dict:
    """``ulysses_attention`` through the flash kernel on this rank's
    sequence shard of chatglm3-6b's q/k/v at ``DIST_LM_ULYSSES``, bf16 and
    f32: its output shard (on the host) and the kernels' launches, the
    counts zeroed just before each call and read just after it."""
    import torch

    from repro_torch.core.partition import local_slice
    from repro_torch.core.ulysses import flash_attn_fn, ulysses_attention

    out = {}
    for dtype, (q, k, v) in job["ulysses"].items():
        q, k, v = (local_slice(t, 1, group).to(device).contiguous() for t in (q, k, v))
        torch.cuda.synchronize()
        _zero_kernel_counts()
        t0 = time.perf_counter()
        o = ulysses_attention(q, k, v, group, causal=True, attn_fn=flash_attn_fn)
        torch.cuda.synchronize()
        out[dtype] = {"out": o.cpu(), "s": time.perf_counter() - t0,
                      "launches": _kernel_counts()}
    return out


def _dist_lm_step(arch: str, groups, device) -> dict:
    """``DIST_LM_STEPS`` bf16 training steps of ``arch`` on (1 x 4) with
    seq_shard and remat (AdamW; each rank its shards), timed after the
    first, with the kernels' launches; then one step with every
    collective timed (``core.collectives.timed``: each waits for the
    card before and after), whose collectives' share of the step is
    reported. Peak memory of this rank."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.core.partition import local_slice
    from repro_torch.launch.comm_analysis import collective_stats
    from repro_torch.models import ParallelPolicy, lm_loss
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step

    cfg = _dist_lm_cfg(arch, "bfloat16")
    pol = ParallelPolicy(mesh=groups, seq_shard=True)
    local = _dist_lm_local(cfg, pol, device)
    layout = _dist_lm_layout(cfg, pol)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg, pol), AdamWConfig(lr=1e-4), layout=layout)
    opt = init_opt_state(local, layout)
    batch = {k: local_slice(v, 0, pol.data_group) for k, v in _dist_lm_batch(cfg, device).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(DIST_LM_STEPS):
        if i == 1:
            _zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launched = _kernel_counts()
    with collectives.timed() as count:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, batch)
        torch.cuda.synchronize()
        timed = time.perf_counter() - t0
    return {"times": times, "losses": losses, "launches": launched,
            "counted_steps": DIST_LM_STEPS - 1, "timed_step_s": timed,
            "collectives_s": count["seconds"], "collectives_calls": count["calls"],
            "wire": collective_stats(count["ops"]).to_dict(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _dist_lm_rank(rank, world_size, device, job):
    """One rank of phase `dist lm` (``_dist_lm_rank_work``). The job's CUDA
    tensors are the parent's, mapped by CUDA IPC: the rank drops every
    reference to them before it returns, so that the parent's count of
    their users falls to zero before it frees them (a producer that exits
    with users still counted warns, and its exit can crash)."""
    import gc

    import torch

    try:
        return _dist_lm_rank_work(rank, world_size, device, job)
    finally:
        job.clear()
        gc.collect()
        torch.cuda.synchronize()


def _dist_lm_rank_work(rank, world_size, device, job):
    """The gates of every arch on every layout, Ulysses, the timed bf16
    steps, then on rank 0 alone (the others wait) both kernels timed at
    the shard shapes: in a process that has run no profiler before, whose
    traces keep every kernel (late in the script's own process they miss
    some, and the timing falls back to events)."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import ParallelPolicy

    groups = _dist_lm_setup(world_size)
    out = {"gates": {}}
    for arch in DIST_LM_ARCHS:
        for name, p, sp in DIST_LM_LAYOUTS:
            pol = ParallelPolicy(mesh=groups[name], seq_shard=sp, remat=False)
            d, m = pol.data_group.rank(), pol.model_group.rank()
            serial = job["serial"][arch, name]
            recorded = serial["routes"].get((d, m)) if serial["routes"] else None
            t = time.perf_counter()
            out["gates"][arch, name] = _dist_lm_gate(arch, pol, serial, recorded, device,
                                                     cut=DIST_LM_CUTS.get((arch, name)))
            out["gates"][arch, name]["wall_s"] = time.perf_counter() - t
    out["ulysses"] = _dist_lm_ulysses(groups["1x4"]["model"], job, device)
    torch.cuda.empty_cache()
    out["step"] = {}
    for arch in DIST_LM_STEP_ARCHS:
        out["step"][arch] = _dist_lm_step(arch, groups["1x4"], device)
        torch.cuda.empty_cache()
    out["whisper"] = _dist_whisper_rank(groups, job, device)
    torch.cuda.empty_cache()
    if rank == 0:
        out["times"] = _dist_lm_kernel_times(job["gpu"])
        out["times"]["flash"].update(_whisper_flash_times(
            {f"{layout} {name}": shape for layout, shapes in WHISPER_DIST_FLASH.items()
             for name, shape in shapes.items()}, "dist lm", job["gpu"]))
        _free_cuda()
    dist.barrier()
    return out


def _dist_lm_check_gates(ranks, serial: dict, gpu: str) -> dict:
    """Every rank's gate results of every (arch, layout): the loss within
    ``DIST_LM_LOSS_RTOL`` of the serial one, every leaf at the gradient
    gate, no wrong answer passing it, the cut run refused, the launches
    exact and equal on every rank; returns what is printed."""
    from repro_torch.models.transformer import flash_per_prefill, norms_per_forward

    out = {}
    for key in ranks[0]["gates"]:
        arch, layout = key
        cfg = _dist_lm_cfg(arch, "float32")
        runs = [r["gates"][key] for r in ranks]
        ref = serial[key]
        p = dict((n, p) for n, p, _ in DIST_LM_LAYOUTS)[layout]
        want = {"rmsnorm": norms_per_forward(cfg, p), "flash": flash_per_prefill(cfg, DIST_LM_SEQ)}
        launches = [run["launches"] for run in runs]
        if any(n != want for n in launches):
            raise SystemExit(f"[dist lm] {arch} {layout}: launches per rank {launches}, want {want}")
        rel = max(abs(run["loss"] - ref["loss"]) / abs(ref["loss"]) for run in runs)
        faults, worst, wrong = [], (0.0, ""), []
        for r, run in enumerate(runs):
            for name, g in run["gates"].items():
                if not g["ok"]:
                    faults.append(f"rank {r} {name}: max|d| {g['max_d']:.3e} (max|ref| "
                                  f"{g['max_ref']:.3e})")
                worst = max(worst, (g["max_d"] / g["max_ref"] if g["max_ref"] else 0.0, name))
                wrong += [f"rank {r} {name}: {w}" for w in g["passed_wrong"]]
        flips = [run["flips"] for run in runs if run["flips"] is not None]
        routed = ""
        if flips:
            n, tied, tokens = (sum(f[k] for f in flips) for k in ("flips", "tied", "tokens"))
            routed = (f"; MoE routes replayed from the serial run's shards: {n} of {tokens} tokens' "
                      f"own top-k differ ({tied} on exact ties), the serial per-shard capacity "
                      f"dropped {ref['drop_share']:.2%} of the entries")
        n_leaves = len(runs[0]["gates"])
        print(f"[dist lm] {arch} on {layout}: loss {runs[0]['loss']:.6f} vs serial "
              f"{ref['loss']:.6f} (max relative difference {rel:.3e} over the ranks, gate "
              f"{DIST_LM_LOSS_RTOL}); {n_leaves} leaves a rank at rtol {DIST_LM_GRAD_RTOL}, atol "
              f"{DIST_GRAD_LEAF_ATOL} x max|ref|: worst max|d|/max|ref| {worst[0]:.3e} ({worst[1]}); "
              f"launches a rank {launches[0]} (exact, equal on the {len(runs)} ranks); "
              f"forward + backward {max(run['s'] for run in runs):.2f}s{routed}; {gpu}")
        if not rel <= DIST_LM_LOSS_RTOL or faults or wrong:
            raise SystemExit(f"[dist lm] {arch} on {layout}: loss rel {rel:.3e}; "
                             + "; ".join((faults + wrong)[:8]))
        if "cut" in runs[0]:
            kind = runs[0]["cut_kind"]
            names = sorted({name for run in runs for name, g in run["cut"].items() if not g["ok"]})
            what = ("the kernels' outputs cut from the graph" if kind == "kernels" else
                    "w_B's sum over the model group cut (no copy_to)")
            print(f"[dist lm] {arch} on {layout}: the gate on a run with {what} refuses "
                  f"{sum(not g['ok'] for run in runs for g in run['cut'].values())} leaves over "
                  f"the ranks ({names[:4]})")
            if not names or (kind == "w_B" and "layers.mixer.w_B" not in names):
                raise SystemExit(f"[dist lm] the gradient gate did not refuse the {kind} cut")
        out[f"{arch} {layout}"] = {"loss": runs[0]["loss"], "serial_loss": ref["loss"],
                                   "loss_rel": rel, "grad_worst": worst[0],
                                   "launches": launches[0],
                                   "flips": sum(f["flips"] for f in flips) if flips else None}
    return out


def _dist_lm_check_ulysses(ranks, job: dict, gpu: str) -> dict:
    """The ranks' Ulysses outputs, concatenated along the sequence, against
    the serial flash kernel on the whole sequence (``_lm_check``: one bf16
    rounding, or 1e-5 in f32); one flash launch a rank and call, and no
    RMSNorm launch."""
    import torch

    out = {}
    for dtype, want in job["ulysses_ref"].items():
        got = torch.cat([r["ulysses"][dtype]["out"] for r in ranks], 1)
        launches = [r["ulysses"][dtype]["launches"] for r in ranks]
        if launches != [{"rmsnorm": 0, "flash": 1}] * len(ranks):
            raise SystemExit(f"[dist lm] ulysses {dtype}: launches per rank {launches}")
        b, s = DIST_LM_ULYSSES
        err = _lm_check(f"dist lm ulysses {dtype} (b {b}, s {s}, 32 q / 2 kv heads, 8 q heads "
                        f"and 1 kv head a rank)", got, want.cpu())
        wall = max(r["ulysses"][dtype]["s"] for r in ranks)
        print(f"[dist lm] ulysses {dtype}: {wall * 1e3:.1f} ms on the slowest rank (two "
              f"all-to-alls and an all-gather through gloo, the flash kernel); {gpu}")
        out[dtype] = {"max_abs_err": err, "wall_s": wall, "launches": launches[0]}
    return out


def _dist_lm_report_step(ranks, arch: str, gpu: str) -> dict:
    """The timed bf16 steps of ``arch`` on every rank: step ms, the
    collectives' share, peak memory, tokens/s; the launches exact and
    equal on every rank."""
    from repro_torch.models.transformer import train_launches

    cfg = _dist_lm_cfg(arch, "bfloat16")
    per = train_launches(cfg, DIST_LM_SEQ, DIST_RANKS)
    steps = [r["step"][arch] for r in ranks]
    want = {k: steps[0]["counted_steps"] * v for k, v in per.items()}
    if any(st["launches"] != want for st in steps):
        raise SystemExit(f"[dist lm] {arch} step launches per rank "
                         f"{[st['launches'] for st in steps]}, want {want} (a pass {per})")
    if not all(np.isfinite(st["losses"]).all() for st in steps):
        raise SystemExit(f"[dist lm] an {arch} training loss is not finite")
    step_ms = [float(np.mean(st["times"][1:]) * 1e3) for st in steps]
    share = [st["collectives_s"] / st["timed_step_s"] for st in steps]
    tokens = DIST_LM_BATCH * DIST_LM_SEQ
    for r, st in enumerate(steps):
        print(f"[dist lm] {arch} step rank {r}: {step_ms[r]:.1f} ms after the first "
              f"({st['times'][0] * 1e3:.1f} ms); collectives {st['collectives_s'] * 1e3:.1f} ms "
              f"({st['collectives_calls']} calls) of a {st['timed_step_s'] * 1e3:.1f} ms step with "
              f"each one timed ({share[r]:.1%}), {_wire_words(st['wire'])}; peak "
              f"{st['peak_gib']:.2f} GiB; losses {[round(x, 6) for x in st['losses']]}")
    print(f"[dist lm] {arch} bf16 on 1 x 4 (seq_shard, remat, AdamW): "
          f"{tokens / (max(step_ms) / 1e3):.0f} tokens/s at the slowest rank's step "
          f"({max(step_ms):.1f} ms); launches a rank {steps[0]['launches']} over "
          f"{steps[0]['counted_steps']} steps (a pass {per}); {gpu}")
    return {"step_ms": step_ms, "collectives_share": share,
            "wire_bytes": steps[0]["wire"]["total_bytes"],
            "peak_gib": [st["peak_gib"] for st in steps], "tokens_per_s": tokens / (max(step_ms) / 1e3),
            "launches": steps[0]["launches"]}


def _dist_lm_kernel_times(gpu: str) -> dict:
    """Both kernels at the shard shapes the dist paths give each rank, bf16:
    held to their plain versions and timed by device time beside their
    bound and the library call (SDPA, ``F.rms_norm``)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(DIST_LM_SEED + 2)

    def randn(shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    flash = {}
    # (b, heads, kv heads, s, head dim); MLA's dh_nope + dh_rope, v padded to it
    for name, (b, h, kvh, s, hd) in {
            "chatglm3-6b 1x4 (b 2, 8 q heads, kv 1)": (2, 8, 1, DIST_LM_SEQ, 128),
            "chatglm3-6b 2x2 (b 1, 16 q heads, kv 1)": (1, 16, 1, DIST_LM_SEQ, 128),
            "deepseek-moe-16b 1x4 (b 2, 4 heads)": (2, 4, 4, DIST_LM_SEQ, 128),
            "deepseek-moe-16b 2x2 (b 1, 8 heads)": (1, 8, 8, DIST_LM_SEQ, 128),
            "chatglm3-6b ulysses (b 1, 8 q heads, kv 1, s 4096)": (1, 8, 1, DIST_LM_ULYSSES[1],
                                                                   128),
            "deepseek-v2-lite-16b MLA 1x4 (b 2, 4 heads x 192)": (2, 4, 4, DIST_LM_SEQ, 192),
            "deepseek-v2-lite-16b MLA 2x2 (b 1, 8 heads x 192)": (1, 8, 8, DIST_LM_SEQ, 192),
            # 10 heads padded to 12: 3 a rank; ranks 0-2 read the one kv head as
            # a group, rank 3 (1 real head, 2 padded) one kv head a q head
            "recurrentgemma-2b 1x4 (b 2, 3 q heads, kv 1, x 256)": (2, 3, 1, DIST_LM_SEQ, 256),
            "recurrentgemma-2b 1x4 padded rank (b 2, 3 q heads, kv 3, x 256)": (
                2, 3, 3, DIST_LM_SEQ, 256),
            "recurrentgemma-2b 2x2 (b 1, 5 q heads, kv 1, x 256)": (1, 5, 1, DIST_LM_SEQ, 256),
    }.items():
        q = randn((b, s, h, hd)).transpose(1, 2)
        k, v = (randn((b, s, kvh, hd)).transpose(1, 2) for _ in range(2))
        err = _lm_check(f"dist lm flash {name}", flash_attention(q, k, v), flash_attention_ref(q, k, v))
        ms, by_ms = device_ms(lambda: flash_attention(q, k, v), n=10)
        plain, by_plain = device_ms(lambda: flash_attention_ref(q, k, v), n=5)
        lib, by_lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal_lower_right(s, s), enable_gqa=True), n=10)
        bound, by = _flash_bound_ms(b, h, kvh, s, s, hd, True, 2)
        print(f"[dist lm] flash {name}, device time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"SDPA {lib:.4f} ms (kernel / SDPA {ms / lib:.2f}), bound {bound * 1e3:.2f} us "
              f"({by}); {gpu}")
        flash[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                           bound_by=by, timed_by={"ms": by_ms, "plain_ms": by_plain,
                                                  "library_ms": by_lib})
        del q, k, v
    rms = {}
    for name, (rows, d) in {
            "chatglm3-6b 1x4 seq_shard [512, 4096]": (DIST_LM_BATCH * DIST_LM_SEQ // 4, 4096),
            "chatglm3-6b 2x2 [1024, 4096]": (DIST_LM_SEQ, 4096),
            "deepseek-moe-16b, v2-lite 1x4 seq_shard [512, 2048]": (
                DIST_LM_BATCH * DIST_LM_SEQ // 4, 2048),
            "deepseek-moe-16b, v2-lite 2x2 [1024, 2048]": (DIST_LM_SEQ, 2048),
            # MLA's kv_norm runs on the whole sequence on every rank
            "deepseek-v2-lite-16b kv_norm 1x4 [2048, 512]": (DIST_LM_BATCH * DIST_LM_SEQ, 512),
            "deepseek-v2-lite-16b kv_norm 2x2 [1024, 512]": (DIST_LM_SEQ, 512),
            "mamba2-370m 1x4 seq_shard [512, 1024]": (DIST_LM_BATCH * DIST_LM_SEQ // 4, 1024),
            "mamba2-370m 2x2 [1024, 1024]": (DIST_LM_SEQ, 1024),
            "recurrentgemma-2b 1x4 seq_shard [512, 2560]": (DIST_LM_BATCH * DIST_LM_SEQ // 4, 2560),
            "recurrentgemma-2b 2x2 [1024, 2560]": (DIST_LM_SEQ, 2560),
    }.items():
        x, w = randn((rows, d)), 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        err = _lm_check(f"dist lm rmsnorm {name}", rmsnorm(x, w), rmsnorm_ref(x, w))
        ms, by_ms = device_ms(lambda: rmsnorm(x, w))
        plain, by_plain = device_ms(lambda: rmsnorm_ref(x, w))
        lib, by_lib = device_ms(lambda: F.rms_norm(x.float(), (d,), w, eps=1e-6).to(x.dtype))
        bound, by = _rmsnorm_bound_ms(rows, d, 2)
        print(f"[dist lm] rmsnorm {name} bf16, device time: kernel {ms * 1e3:.2f} us "
              f"({bound / ms:.0%} of bound), plain {plain * 1e3:.2f} us, F.rms_norm "
              f"{lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({by}); {gpu}")
        rms[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by, timed_by={"ms": by_ms, "plain_ms": by_plain,
                                                "library_ms": by_lib})
    _free_cuda()
    return {"flash": flash, "rmsnorm": rms}


def _dist_lm_cli(gpu: str) -> dict:
    """``train --mode lm --arch deepseek-moe-16b`` (reduced) on 2 ranks
    through a fault, its data ranks routing together, against one rank
    uninterrupted: the final loss within ``DIST_LM_CLI_RTOL``."""
    import tempfile

    base = ["--arch", "deepseek-moe-16b", "--steps", str(DIST_LM_CLI_STEPS), "--save-every", "2"]
    with tempfile.TemporaryDirectory() as d:
        jobs = {"one": [*base, "--ckpt-dir", os.path.join(d, "one")],
                "two": [*base, "--devices", "2", "--inject-fault", str(DIST_LM_CLI_FAULT),
                        "--ckpt-dir", os.path.join(d, "two")]}
        with ThreadPoolExecutor(max_workers=2) as pool:
            runs = {tag: f.result() for tag, f in
                    {tag: pool.submit(_lm_train_cli_run, flags) for tag, flags in jobs.items()}.items()}
    for tag, run in runs.items():
        if run.returncode != 0:
            print(run.stdout, run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"[dist lm cli] {tag} exited {run.returncode}")
    if "failures=1 restores=1" not in runs["two"].stdout:
        raise SystemExit("[dist lm cli] the 2-rank run's fault was not restored from a checkpoint")
    want = json.loads(re.search(r"^losses: (.*)$", runs["one"].stdout, re.M).group(1))
    out = _lm_train_cli_check("deepseek-moe-16b --devices 2", runs["two"], want, float("inf"), gpu)
    got = json.loads(re.search(r"^losses: (.*)$", runs["two"].stdout, re.M).group(1))
    final = abs(got[-1] - want[-1]) / abs(want[-1])
    print(f"[dist lm cli] deepseek-moe-16b on 2 ranks through a fault: final loss {got[-1]:.6f} "
          f"vs one rank's {want[-1]:.6f} (relative {final:.3e}, gate {DIST_LM_CLI_RTOL}); "
          f"first {got[0]:.6f} vs {want[0]:.6f}; {gpu}")
    if not final <= DIST_LM_CLI_RTOL:
        raise SystemExit("[dist lm cli] the 2-rank run did not end on one rank's loss")
    return dict(out, final_rel=final)


# ---------------------------------------------------------------------------
# whisper-tiny over the ranks in phase `dist lm`: full width and depth,
# trained tensor-parallel by heads (6 padded to 8 at P = 4), its loss and
# gradients against the serial run on the card, two cut sums refused, two
# bf16 AdamW steps timed
# ---------------------------------------------------------------------------

WHISPER_DIST_BATCH, WHISPER_DIST_SEQ = 4, 448
WHISPER_DIST_SEED = DIST_LM_SEED + 7
# the cut runs, by layout: the cross-attention's row-parallel sum
# (``layers.tp_out``) on (2 x 2), the cheaper pass; the LayerNorms'
# ``copy_to``, which only a slice of the sequence needs, on (1 x 4) seq_shard
WHISPER_DIST_CUTS = {"2x2": ("cross",), "1x4": ("layernorm",)}


def _whisper_dist_cfg(dtype: str):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(WHISPER_ARCH), dtype=dtype)


def _whisper_dist_params(cfg, device, serving: bool = False):
    import torch

    from repro_torch.models import init_whisper_params

    return init_whisper_params(cfg, generator=torch.Generator(device=device).manual_seed(
        WHISPER_DIST_SEED), device=device, serving=serving)


def _whisper_dist_batch(cfg, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(WHISPER_DIST_SEED + 1)
    frames = torch.randn((WHISPER_DIST_BATCH, cfg.encoder.frames, cfg.d_model), generator=gen,
                         device=device)
    toks = torch.randint(1, cfg.vocab, (WHISPER_DIST_BATCH, WHISPER_DIST_SEQ + 1), generator=gen,
                         device=device)
    return {"frames": frames, "tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _leaf_scales(grads) -> dict:
    """Each leaf's max|ref|; a key bias's, whose exact gradient is zero (the
    softmax cancels q . bk) and both runs' rounding noise, is its layer's
    query bias's (``_grad_gate_faults``' rule)."""
    scale = {name: float(g.abs().max()) for name, g, _ in _tree_pairs(grads, None)}
    return {name: scale[name[:-2] + "bq"] if name.endswith(".bk") else s
            for name, s in scale.items()}


def _dist_whisper_serial(gpu: str, dev) -> dict:
    """The serial f32 ``whisper_loss`` and its gradient on the card through
    the flash kernel (exact launches), with each leaf's scale."""
    import torch

    from repro_torch.models import whisper_loss
    from repro_torch.models.whisper import flash_per_loss
    from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree

    cfg = _whisper_dist_cfg("float32")
    params = _whisper_dist_params(cfg, dev)
    batch = _whisper_dist_batch(cfg, dev)
    grads = zeros_like_tree(params)
    _zero_kernel_counts()
    t0 = time.perf_counter()
    loss, _ = accumulate_grads(lambda p, b: whisper_loss(p, b, cfg), params, batch, grads)
    torch.cuda.synchronize()
    launched, want = _kernel_counts(), {"rmsnorm": 0, "flash": flash_per_loss(cfg)}
    if launched != want:
        raise SystemExit(f"[dist lm] serial whisper: launches {launched}, want {want}")
    print(f"[dist lm] serial {cfg.name} f32 ({cfg.encoder.n_layers} + {cfg.n_layers} layers, "
          f"batch {WHISPER_DIST_BATCH} x {WHISPER_DIST_SEQ} tokens, {cfg.encoder.frames} frames): "
          f"loss {float(loss):.6f} in {time.perf_counter() - t0:.2f}s, launches {launched}; {gpu}")
    del params
    return {"loss": float(loss), "grads": grads, "scale": _leaf_scales(grads)}


@contextlib.contextmanager
def cut_cross_reduce():
    """Within the block the cross-attention's row-parallel output is not
    summed over the model group: ``layers.tp_out`` is the identity (this
    rank's slice under ``seq_shard``) inside an ``_attn_tp`` given
    ``kv_x``. The loss moves: the gate must refuse the run."""
    import repro_torch.models.attention as attn_lib
    import repro_torch.models.layers as layers_lib
    from repro_torch.core.collectives import scatter_to

    saved = attn_lib._attn_tp

    def cut(*args, kv_x=None, **kw):
        if kv_x is None:
            return saved(*args, **kw)
        tp_out = layers_lib.tp_out
        layers_lib.tp_out = lambda y, group, sp: scatter_to(y, 1, group) if sp else y
        try:
            return saved(*args, kv_x=kv_x, **kw)
        finally:
            layers_lib.tp_out = tp_out

    attn_lib._attn_tp = cut
    try:
        yield
    finally:
        attn_lib._attn_tp = saved


@contextlib.contextmanager
def cut_layernorm_sum():
    """Within the block the LayerNorms on a rank's slice of the sequence
    take w and b without ``copy_to``: the loss is the same, each norm's
    gradient a rank's part, which the gate must refuse."""
    import repro_torch.models.whisper as wh

    saved = wh._ln_of
    wh._ln_of = lambda x, p, policy, sp: wh._ln(x, p)
    try:
        yield
    finally:
        wh._ln_of = saved


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _whisper_local(cfg, pol, device, serving: bool = False) -> dict:
    """This rank's shards of the seeded weights, drawn in turns."""
    return _shards_in_turns(lambda: _whisper_dist_params(cfg, device, serving), cfg, pol)


def _whisper_layout(cfg, pol):
    from repro_torch.common.tree import tree_map
    from repro_torch.models.transformer import param_parts
    from repro_torch.train.optimizer import state_layout

    from repro_torch.models import init_whisper_params

    whole = init_whisper_params(cfg, generator=None, device="meta")  # shapes only
    return state_layout(pol.mesh, param_parts(cfg, pol, whole),
                        tree_map(lambda p: tuple(p.shape), whole), grads_complete=True)


def _dist_whisper_gate(pol, serial: dict, device, cuts=()) -> dict:
    """One f32 forward + backward of ``whisper_loss`` on this rank's shards
    and rows, its gradients reduced by ``reduce_grads``'s LM rule and each
    leaf gated against the serial gradient (``_dist_lm_leaf_gate``); the
    same for each run of ``cuts``. The bytes of this rank's shards and its
    peak memory, for phase ``dryrun``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.partition import local_slice
    from repro_torch.models import whisper_loss
    from repro_torch.models.transformer import tree_specs
    from repro_torch.train.train_loop import accumulate_grads, reduce_grads, zeros_like_tree

    cfg = _whisper_dist_cfg("float32")
    torch.cuda.reset_peak_memory_stats()
    local = _whisper_local(cfg, pol, device)
    batch = {k: local_slice(v, 0, pol.data_group)
             for k, v in _whisper_dist_batch(cfg, device).items()}
    layout = _whisper_layout(cfg, pol)
    specs = {name: spec for name, spec, _ in _tree_pairs(tree_specs(cfg, pol), None)}
    refs = {name: ref for name, ref, _ in _tree_pairs(serial["grads"], None)}

    def run(ctx):
        grads = zeros_like_tree(local)
        _zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            loss, _ = accumulate_grads(lambda p, b: whisper_loss(p, b, cfg, pol), local, batch,
                                       grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _kernel_counts()
        reduce_grads(grads, layout)
        mean = loss.clone()
        dist.all_reduce(mean, group=pol.data_group)
        gates = {name: _dist_lm_leaf_gate(g, refs[name], specs[name], pol, serial["scale"][name])
                 for name, g, _ in _tree_pairs(grads, None)}
        for name, g in gates.items():
            if name.endswith(".bk"):  # its exact gradient is zero: zeros are no wrong answer
                g["passed_wrong"] = []
        return {"loss": float(mean) / pol.dp_size(), "s": wall, "launches": launched,
                "gates": gates}

    out = run(contextlib.nullcontext())
    out["param_bytes"] = _tree_bytes(local)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["cut"] = {what: run(cut_cross_reduce() if what == "cross" else cut_layernorm_sum())
                  for what in cuts}
    del local
    torch.cuda.empty_cache()
    return out


def _dist_whisper_step(groups, device) -> dict:
    """bf16 whisper-tiny training on (1 x 4) with seq_shard: ``DIST_LM_STEPS``
    AdamW steps timed after the first, then one step with every collective
    timed (its share of the step and its bytes on the wire)."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.core.partition import local_slice
    from repro_torch.launch.comm_analysis import collective_stats
    from repro_torch.models import ParallelPolicy, whisper_loss
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step

    cfg = _whisper_dist_cfg("bfloat16")
    pol = ParallelPolicy(mesh=groups, seq_shard=True)
    local = _whisper_local(cfg, pol, device)
    layout = _whisper_layout(cfg, pol)
    step = make_train_step(lambda p, b: whisper_loss(p, b, cfg, pol), AdamWConfig(lr=1e-4),
                           layout=layout)
    opt = init_opt_state(local, layout)
    batch = {k: local_slice(v, 0, pol.data_group)
             for k, v in _whisper_dist_batch(cfg, device).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(DIST_LM_STEPS):
        if i == 1:
            _zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launched = _kernel_counts()
    with collectives.timed() as count:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, batch)
        torch.cuda.synchronize()
        timed = time.perf_counter() - t0
    return {"times": times, "losses": losses, "launches": launched,
            "counted_steps": DIST_LM_STEPS - 1, "timed_step_s": timed,
            "collectives_s": count["seconds"], "collectives_calls": count["calls"],
            "wire": collective_stats(count["ops"]).to_dict(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _dist_whisper_rank(groups: dict, job: dict, device) -> dict:
    """whisper-tiny's gates on every layout (with ``WHISPER_DIST_CUTS``),
    then its timed bf16 steps."""
    from repro_torch.models import ParallelPolicy

    out = {"gates": {}}
    for name, _, sp in DIST_LM_LAYOUTS:
        pol = ParallelPolicy(mesh=groups[name], seq_shard=sp, remat=False)
        out["gates"][name] = _dist_whisper_gate(pol, job["whisper"], device,
                                                WHISPER_DIST_CUTS[name])
    out["step"] = _dist_whisper_step(groups["1x4"], device)
    return out


def _wire_words(wire: dict) -> str:
    kinds = ", ".join(f"{k} {v / 2**20:.1f} MiB ({wire['count_by_kind'][k]} calls)"
                      for k, v in sorted(wire["bytes_by_kind"].items()))
    return f"{wire['total_bytes'] / 2**20:.1f} MiB on the wire a rank ({kinds})"


def _dist_whisper_check(ranks, serial: dict, gpu: str) -> dict:
    """Every rank's whisper gates: the loss within ``DIST_LM_LOSS_RTOL``,
    every leaf at the gradient gate with no wrong answer passing, flash's
    launches exact and equal (``flash_per_loss``), each cut refused; then
    the timed steps. Returns what is recorded."""
    from repro_torch.models.whisper import flash_per_loss

    cfg = _whisper_dist_cfg("float32")
    want = {"rmsnorm": 0, "flash": flash_per_loss(cfg)}
    out = {}
    for name, _, sp in DIST_LM_LAYOUTS:
        runs = [r["whisper"]["gates"][name] for r in ranks]
        if any(run["launches"] != want for run in runs):
            raise SystemExit(f"[dist lm] whisper {name}: launches per rank "
                             f"{[run['launches'] for run in runs]}, want {want}")
        rel = max(abs(run["loss"] - serial["loss"]) / abs(serial["loss"]) for run in runs)
        faults, worst, wrong = [], (0.0, ""), []
        for r, run in enumerate(runs):
            for leaf, g in run["gates"].items():
                if not g["ok"]:
                    faults.append(f"rank {r} {leaf}: max|d| {g['max_d']:.3e} (max|ref| "
                                  f"{g['max_ref']:.3e})")
                worst = max(worst, (g["max_d"] / g["max_ref"] if g["max_ref"] else 0.0, leaf))
                wrong += [f"rank {r} {leaf}: {w}" for w in g["passed_wrong"]]
        print(f"[dist lm] {WHISPER_ARCH} on {name}{' seq_shard' if sp else ''}: loss "
              f"{runs[0]['loss']:.6f} vs serial {serial['loss']:.6f} (max relative difference "
              f"{rel:.3e}, gate {DIST_LM_LOSS_RTOL}); {len(runs[0]['gates'])} leaves a rank at rtol "
              f"{DIST_LM_GRAD_RTOL}, atol {DIST_GRAD_LEAF_ATOL} x max|ref| (a key bias's of its "
              f"query bias's): worst {worst[0]:.3e} ({worst[1]}); launches a rank "
              f"{runs[0]['launches']} (exact, equal); forward + backward "
              f"{max(run['s'] for run in runs):.2f}s; {gpu}")
        if not rel <= DIST_LM_LOSS_RTOL or faults or wrong:
            raise SystemExit(f"[dist lm] whisper on {name}: loss rel {rel:.3e}; "
                             + "; ".join((faults + wrong)[:8]))
        for what, _ in runs[0]["cut"].items():
            cut = [run["cut"][what] for run in runs]
            crel = max(abs(c["loss"] - serial["loss"]) / abs(serial["loss"]) for c in cut)
            bad = sorted({leaf for c in cut for leaf, g in c["gates"].items() if not g["ok"]})
            print(f"[dist lm] {WHISPER_ARCH} on {name} with "
                  f"{'the cross-attention sum cut' if what == 'cross' else 'the LayerNorms copy_to cut'}: "
                  f"loss {crel:.3e} from the serial one, {len(bad)} leaves refused ({bad[:3]})")
            refused = (crel > DIST_LM_LOSS_RTOL or bad) if what == "cross" else \
                any(".ln" in leaf or "final_ln" in leaf for leaf in bad)
            if not refused:
                raise SystemExit(f"[dist lm] whisper: the gate did not refuse the {what} cut")
        out[name] = {"loss_rel": rel, "grad_worst": worst[0], "launches": runs[0]["launches"],
                     "param_bytes": [run["param_bytes"] for run in runs],
                     "peak_gib": [run["peak_gib"] for run in runs]}
    steps = [r["whisper"]["step"] for r in ranks]
    per = {"rmsnorm": 0, "flash": flash_per_loss(cfg)}
    want = {k: steps[0]["counted_steps"] * v for k, v in per.items()}
    if any(st["launches"] != want for st in steps) or not all(
            np.isfinite(st["losses"]).all() for st in steps):
        raise SystemExit(f"[dist lm] whisper step launches {[st['launches'] for st in steps]}, "
                         f"want {want}; losses {[st['losses'] for st in steps]}")
    step_ms = [float(np.mean(st["times"][1:]) * 1e3) for st in steps]
    share = [st["collectives_s"] / st["timed_step_s"] for st in steps]
    tokens = WHISPER_DIST_BATCH * WHISPER_DIST_SEQ
    for r, st in enumerate(steps):
        print(f"[dist lm] {WHISPER_ARCH} step rank {r}: {step_ms[r]:.1f} ms after the first "
              f"({st['times'][0] * 1e3:.1f} ms); collectives {st['collectives_s'] * 1e3:.1f} ms "
              f"({st['collectives_calls']} calls) of a {st['timed_step_s'] * 1e3:.1f} ms step with "
              f"each one timed ({share[r]:.1%}), {_wire_words(st['wire'])}; peak "
              f"{st['peak_gib']:.2f} GiB; losses {[round(x, 6) for x in st['losses']]}")
    print(f"[dist lm] {WHISPER_ARCH} bf16 on 1 x 4 (seq_shard, AdamW): "
          f"{tokens / (max(step_ms) / 1e3):.0f} decoder tokens/s at the slowest rank's step "
          f"({max(step_ms):.1f} ms); launches a rank {steps[0]['launches']} over "
          f"{steps[0]['counted_steps']} steps; {gpu}")
    out["step"] = {"step_ms": step_ms, "collectives_share": share,
                   "wire_bytes": steps[0]["wire"]["total_bytes"],
                   "peak_gib": [st["peak_gib"] for st in steps], "launches": steps[0]["launches"],
                   "tokens_per_s": tokens / (max(step_ms) / 1e3)}
    return out


# flash at whisper-tiny's shard shapes over the ranks (b, heads, kv heads,
# sq, sk, causal): 6 heads padded to 8 at P = 4 (2 a rank, batch 4), 3 a
# rank at P = 2 (2 rows a data rank)
WHISPER_DIST_FLASH = {
    "1x4": {"encoder": (4, 2, 2, 1500, 1500, False), "cross (loss)": (4, 2, 2, 448, 1500, False),
            "self (loss, causal)": (4, 2, 2, 448, 448, True)},
    "2x2": {"encoder": (2, 3, 3, 1500, 1500, False), "cross (loss)": (2, 3, 3, 448, 1500, False),
            "self (loss, causal)": (2, 3, 3, 448, 448, True)},
}
WHISPER_DIST_DECODE_FLASH = {"1x4": (4, 2, 2, 1, 1500, False), "2x2": (2, 3, 3, 1, 1500, False)}


def _whisper_flash_times(shapes: dict, tag: str, gpu: str) -> dict:
    """Flash at whisper-tiny's shard shapes, bf16 and f32 (bf16 through
    ``wgmma``, f32 on the FFMA kernel): held to the plain version, timed by
    device time beside its bound and SDPA (masked only when causal)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(WHISPER_DIST_SEED + 2)
    out = {}
    for name, (b, h, kvh, sq, sk, causal) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, sq, h, 64), device=dev, generator=gen).to(dtype).transpose(1, 2)
            k, v = (torch.randn((b, sk, kvh, 64), device=dev, generator=gen).to(dtype)
                    .transpose(1, 2) for _ in range(2))
            dn = str(dtype).split(".")[-1]
            what = f"{name} (b {b}, {h} heads, sq {sq}, sk {sk}) {dn}"
            err = _lm_check(f"{tag} flash whisper {what}", flash_attention(q, k, v, causal=causal),
                            flash_attention_ref(q, k, v, causal=causal))
            ms, by_ms = device_ms(lambda: flash_attention(q, k, v, causal=causal), n=10)
            plain, by_plain = device_ms(lambda: flash_attention_ref(q, k, v, causal=causal), n=5)
            mask = causal_lower_right(sq, sk) if causal else None
            lib, by_lib = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                    n=10)
            bound, by = _flash_bound_ms(b, h, kvh, sq, sk, 64, causal, q.element_size())
            print(f"[{tag}] flash whisper {what}, device time: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, SDPA {lib:.4f} ms (kernel / SDPA {ms / lib:.2f}), bound "
                  f"{bound * 1e3:.2f} us ({by}); {gpu}")
            out[what] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=by,
                             timed_by={"ms": by_ms, "plain_ms": by_plain, "library_ms": by_lib})
            del q, k, v
    return out


def phase_dist_lm(gpu: str) -> dict:
    """The distributed LM at full width (``DIST_LM_ARCHS``, depth cut) on
    ``DIST_RANKS`` gloo ranks sharing this card: the serial f32 loss and
    gradient on the card first (shared with the ranks by CUDA IPC), then
    one launch of the ranks (``_dist_lm_rank``): the gates on every layout,
    Ulysses with the flash kernel, the timed bf16 steps, both kernels
    timed at the shard shapes; then the CLI on 2 ranks. Returns the launch
    counts by path and the measurements."""
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import launch_ranks

    _free_cuda()
    dev = torch.device("cuda")
    print(f"reduced: timed bf16 training steps 3 -> {DIST_LM_STEPS} (the script's time; the "
          f"first warms up)")
    for arch, n in DIST_LM_ARCHS.items():
        full, cfg = get_arch(arch), _dist_lm_cfg(arch, "float32")
        print(f"reduced: {arch} layers {full.n_layers} -> {n} (kept: "
              f"{_kept_layers(cfg)}; {cfg.approx_params() / 1e9:.3f} B params, "
              f"{cfg.approx_params() * 4 / 1e9:.1f} GB in f32; {full.n_layers} layers are "
              f"{full.approx_params() / 1e9:.2f} B)")
    t0 = time.perf_counter()
    serial = {}
    for arch in DIST_LM_ARCHS:
        moe = _dist_lm_cfg(arch, "float32").moe is not None
        shared = None if moe else _dist_lm_serial(arch, None, gpu, dev)
        for name, p, _ in DIST_LM_LAYOUTS:
            serial[arch, name] = _dist_lm_serial(arch, (DIST_RANKS // p, p), gpu, dev) if moe else shared
    whisper_serial = _dist_whisper_serial(gpu, dev)
    gen = torch.Generator(device=dev).manual_seed(DIST_LM_SEED + 3)
    b, s = DIST_LM_ULYSSES
    ulysses, ulysses_ref = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((b, s, 32, 128), device=dev, generator=gen).to(dtype)
        k, v = (torch.randn((b, s, 2, 128), device=dev, generator=gen).to(dtype) for _ in range(2))
        name = str(dtype).split(".")[-1]
        ulysses[name] = (q, k, v)
        ulysses_ref[name] = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                            v.transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    _free_cuda()  # the ranks need what the serial runs left reserved
    print(f"[dist lm] serial references on the card in {time.perf_counter() - t0:.1f}s; "
          f"{_memory_line()}")
    job = {"serial": serial, "ulysses": ulysses, "gpu": gpu, "whisper": whisper_serial}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = launch_ranks(_dist_lm_rank, DIST_RANKS, d, args=(job,),
                             collective_timeout_s=DIST_TIMEOUT_S, deadline_s=DIST_TIMEOUT_S,
                             device="cuda")
    print(f"[dist lm] {DIST_RANKS} gloo ranks on one card, layouts "
          f"{[(n, f'{DIST_RANKS // p} x {p}', 'seq_shard' if sp else '') for n, p, sp in DIST_LM_LAYOUTS]}: "
          f"{time.perf_counter() - t0:.1f}s for the launch")
    gates = _dist_lm_check_gates(ranks, serial, gpu)
    uly = _dist_lm_check_ulysses(ranks, {"ulysses_ref": ulysses_ref}, gpu)
    step = {arch: _dist_lm_report_step(ranks, arch, gpu) for arch in DIST_LM_STEP_ARCHS}
    whisper = _dist_whisper_check(ranks, whisper_serial, gpu)
    del job, serial, ulysses, ulysses_ref, whisper_serial
    torch.cuda.ipc_collect()
    _free_cuda()
    times = ranks[0]["times"]
    cli = _dist_lm_cli(gpu)
    launches = {
        "dist_lm": {k: sum(g["launches"][k] for g in gates.values())
                    + sum(st["launches"][k] for st in step.values()) for k in ("rmsnorm", "flash")},
        "dist_lm_whisper": {k: sum(whisper[name]["launches"][k] for name, _, _ in DIST_LM_LAYOUTS)
                            + whisper["step"]["launches"][k] for k in ("rmsnorm", "flash")},
        "dist_lm_ulysses": {k: sum(u["launches"][k] for u in uly.values())
                            for k in ("rmsnorm", "flash")},
        "dist_lm_cli": {"rmsnorm": cli["rmsnorm"], "flash": cli["flash"]}}
    return {"launches": launches, "gates": gates, "ulysses": uly, "step": step, "times": times,
            "cli": cli, "whisper": whisper}


# ---------------------------------------------------------------------------
# Phase `dist serve lm`: LM serving over (data x model) ranks: Engine under
# a mesh policy on 4 gloo ranks sharing the card (split caches, the prefix
# sharded by kv heads or by sequence, int8 prefixes), against the serial
# Engine on the card; bf16 serving timed; both kernels at the shard shapes.
# ---------------------------------------------------------------------------

# full width, depth cut: gemma-7b (16 kv heads: a head-sharded prefix) and
# chatglm3-6b (2 kv heads: sequence-sharded on 4 model ranks) 2 of 28
# layers; deepseek-moe-16b and deepseek-v2-lite-16b (MLA: its latent
# prefix sequence-sharded at every P) their dense layer 0 and 1 MoE layer;
# mamba2-370m (the SSM state by heads) 2 of 48 layers and recurrentgemma-2b
# (its ring of 2048 sequence-sharded, the RG-LRU's cache whole) one
# superblock, 3 of 26 layers
DIST_SERVE_ARCHS = {"gemma-7b": 2, "chatglm3-6b": 2, "deepseek-moe-16b": 2,
                    "deepseek-v2-lite-16b": 2, SSM_ARCH: 2, HYBRID_ARCH: 3}
DIST_SERVE_MAX_LEN, DIST_SERVE_SLOTS = 2048, 4
# (prompt length, max_tokens) of the 8 requests: one prompt of 1536, lengths
# that 4 divides and that it does not (the MoE's all-to-all and its other
# path), one request decoding past TAIL_LEN (a tail flush mid-run, then one
# step; cut from 80 tokens, then 72, for the script's time)
DIST_SERVE_FLUSHED = 66
# the timed bf16 runs serve the same requests with each one's tokens capped
# at this (the flushed request's 66 cut for the script's time: 15 decode
# steps, the first not counted)
DIST_SERVE_TIMED_TOKENS = 16
DIST_SERVE_REQUESTS = ((1536, 8), (5, DIST_SERVE_FLUSHED), (300, 8), (1027, 8), (64, 8), (777, 8),
                       (130, 8), (12, 8))
# (layout, ranks to a model group, seq_shard) of every arch's gate runs;
# DIST_SERVE_EXTRA also on (4 x 1) and with kv_quant on (1 x 4), the SSM and
# hybrid archs also on (4 x 1)
DIST_SERVE_LAYOUTS = (("1x4", 4, True), ("2x2", 2, False))
DIST_SERVE_EXTRA = "chatglm3-6b"
# sequence-sharded prefix and ring: the runs whose combine's sum is cut too
DIST_SERVE_CUTS = (("chatglm3-6b", "1x4"), (HYBRID_ARCH, "1x4"))
DIST_SERVE_SEED = 23
# f32 activations and f32 caches: the serial gate of the reference, 1e-4 of
# max|ref|, on prefill and decode logits; int8 prefixes at 3e-2 of max|ref|
# (3x the reference's "~1e-2 relative logit error", policy.py:45-46)
DIST_SERVE_F32, DIST_SERVE_INT8 = 1e-4, 3e-2
# bf16 weights and the reference's bf16 caches against the serial bf16
# Engine: the split decode rounds unnormalised softmax weights to bf16
# where the plain decode rounds normalised ones (the reference's two
# arithmetics), held at the bf16 gate up to a request's first differing token
# or, in the MoE, its first decode step whose routed experts differ: a
# different expert is another function, not a rounding apart. Each such
# flip must be a near tie of the serial run's router, its k-th and
# (k+1)-th logits within 1/16 (eight bf16 spacings of a logit in [1, 2))
DIST_SERVE_BF16 = 3e-2
DIST_SERVE_NEAR_TIE = 2.0 ** -4


def _dist_serve_cfg(arch: str, dtype: str):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch), n_layers=DIST_SERVE_ARCHS[arch], dtype=dtype)


def _dist_serve_shapes(cfg) -> tuple:
    """(prompt length, max_tokens) of ``cfg``'s requests: the phase's
    eight, and under a window one more past it (``HYBRID_EXTRA``'s
    first), whose prefill writes the sequence-sharded ring wrapped."""
    return DIST_SERVE_REQUESTS + (((HYBRID_EXTRA[0], 8),) if cfg.window else ())


def _dist_serve_max_len(cfg) -> int:
    return RECURRENT_MAX_LEN if cfg.window else DIST_SERVE_MAX_LEN


def _dist_serve_requests(cfg, max_tokens: Optional[int] = None) -> list:
    """``cfg``'s requests (``_dist_serve_shapes``), each one's tokens capped
    at ``max_tokens`` if given."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(DIST_SERVE_SEED)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=n).tolist(),
                    max_tokens=m if max_tokens is None else min(m, max_tokens))
            for i, (n, m) in enumerate(_dist_serve_shapes(cfg))]


def _dist_serve_params(cfg, device):
    import torch

    from repro_torch.models import init_lm_params

    return init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(DIST_SERVE_SEED),
                          device=device)


@contextlib.contextmanager
def _serve_log(engine, log: dict):
    """Within the block ``engine``'s prefills log {rid: logits [V]}, its
    decode steps the logits of this rank's rows and, per step, (slot, rid,
    outputs so far) of every active slot."""
    import repro_torch.models.transformer as tf_lib

    runner = engine.runner
    prefill, decode = tf_lib.lm_prefill, tf_lib.lm_decode_step
    admit, step = runner.admit, runner.step
    current = {}

    def admitted(slot, req):
        current["rid"] = req.rid
        return admit(slot, req)

    def stepped(slots, active):
        log["active"].append([(i, slots[i].rid, len(slots[i].output)) for i in active])
        return step(slots, active)

    def prefilled(*args, **kw):
        out = prefill(*args, **kw)
        log["prefill"][current["rid"]] = out[0][0]
        return out

    def decoded(*args, **kw):
        out = decode(*args, **kw)
        log["decode"].append(out[0])
        return out

    runner.admit, runner.step = admitted, stepped
    tf_lib.lm_prefill, tf_lib.lm_decode_step = prefilled, decoded
    try:
        yield
    finally:
        tf_lib.lm_prefill, tf_lib.lm_decode_step = prefill, decode
        del runner.admit, runner.step


@contextlib.contextmanager
def _moe_routes(out: list, prefills: list):
    """Within the block each decode step appends to ``out`` the list of its
    MoE layers' routes: (top-k experts [rows, k], the router's margin
    log p_k - log p_k+1 [rows]), kept on the device; and each prefill
    appends to ``prefills`` the same of the last row of each routing call
    ([k], a scalar): one call a MoE layer, or one a shard where
    ``per_shard_moe`` routes a prompt per slice (its last call then holds
    the prompt's last token), and on a rank of a sequence-sharded mesh the
    last row of its own slice."""
    import repro_torch.models.moe as moe_lib
    import repro_torch.models.transformer as tf_lib

    route, decode, prefill = moe_lib._route, tf_lib.lm_decode_step, tf_lib.lm_prefill
    step = []

    def routed(x_flat, router_w, moe):
        topi, topv, probs = route(x_flat, router_w, moe)
        if step:
            rows = slice(None) if step[-1][0] == "decode" else slice(-1, None)
            top = probs[rows].topk(moe.top_k + 1, dim=-1).values.log()
            step[-1][1].append((topi[rows], top[:, -2] - top[:, -1]))
        return topi, topv, probs

    def run(kind, fn, log):
        def call(*args, **kw):
            step.append((kind, []))
            try:
                return fn(*args, **kw)
            finally:
                calls = step.pop()[1]
                log.append(calls if kind == "decode" else [(t[0], m[0]) for t, m in calls])
        return call

    moe_lib._route = routed
    tf_lib.lm_decode_step = run("decode", decode, out)
    tf_lib.lm_prefill = run("prefill", prefill, prefills)
    try:
        yield
    finally:
        moe_lib._route, tf_lib.lm_decode_step, tf_lib.lm_prefill = route, decode, prefill


def _dist_serve_serial(arch: str, p: int, gpu: str, dev, dtype: str = "float32",
                       max_tokens: Optional[int] = None) -> dict:
    """The serial Engine on the card, f32 activations and f32 caches (or
    bf16 weights and the reference's bf16 caches), the requests' tokens and
    every prefill's and decode step's logits; the MoE layers route the
    prompts that ``p`` model ranks divide per slice, as the expert-parallel
    path does (``per_shard_moe`` on 1 x ``p``). ``max_tokens`` caps each
    request's tokens."""
    import torch

    from repro_torch.models import LOCAL
    from repro_torch.serve import Engine

    cfg = _dist_serve_cfg(arch, dtype)
    engine = Engine(cfg, _dist_serve_params(cfg, dev), max_len=_dist_serve_max_len(cfg),
                    max_batch=DIST_SERVE_SLOTS, device=dev, policy=LOCAL,
                    cache_dtype=getattr(torch, dtype))
    log = {"prefill": {}, "decode": [], "active": []}
    for req in _dist_serve_requests(cfg, max_tokens):
        engine.submit(req)
    t0 = time.perf_counter()
    drops = []
    routed = per_shard_moe((1, p), {}, drops) if cfg.moe else contextlib.nullcontext()
    routes, prefill_routes = [], []
    with routed, _serve_log(engine, log), _moe_routes(routes, prefill_routes):
        done = engine.run_until_done()
    torch.cuda.synchronize()
    what = ""
    if cfg.moe:
        dropped, entries = sum(int(n) for n, _ in drops), sum(e for _, e in drops)
        what = (f", the prompts that {p} divides routed per slice of s/{p}: {dropped} of "
                f"{entries} entries dropped")
    print(f"[dist serve lm] serial {arch} {dtype}: {len(done)} requests, {engine.steps} decode steps "
          f"in {time.perf_counter() - t0:.2f}s{what}; {gpu}")
    out = {"tokens": {r.rid: list(r.output) for r in done}, "prefill": log["prefill"],
           "decode": torch.stack(log["decode"]), "active": log["active"],
           "routes": [[(t.cpu(), m.cpu()) for t, m in step] for step in routes],
           "prefill_routes": {rid: [(t.cpu(), float(m)) for t, m in calls]
                              for rid, calls in zip(log["prefill"], prefill_routes)}}
    del engine
    _free_cuda()
    return out


def _drawn_shards(cfg, pol, device) -> dict:
    """This rank's shards of the seeded f32 weights, drawn in turns."""
    return _shards_in_turns(lambda: _dist_serve_params(cfg, device), cfg, pol)


def _prefix_bytes(cache) -> int:
    from repro_torch.models.transformer import _leaves as cache_leaves

    return sum(t.numel() * t.element_size() for name, t in cache_leaves(cache)
               if name in ("k", "v", "k_scale", "v_scale", "ckv", "kr"))


def _state_bytes(cache) -> int:
    """The bytes of the recurrent caches (the SSM's conv and state, the
    RG-LRU's conv and h) a rank holds."""
    from repro_torch.models.transformer import _leaves as cache_leaves

    return sum(t.numel() * t.element_size() for name, t in cache_leaves(cache)
               if name in ("conv", "state", "h"))


def _rank_state_bytes(cfg, p: int, rows: int) -> int:
    """What ``_state_bytes`` must read on a rank of a model group of ``p``
    holding ``rows`` slots: the SSM state's H/P heads and its whole conv
    cache; the RG-LRU's conv and h whole; all float32."""
    n = 0
    for kind in cfg.layer_kinds():
        if kind == "ssm":
            ssm = cfg.ssm
            n += (ssm.conv_kernel * ssm.conv_dim(cfg.d_model)
                  + ssm.n_heads(cfg.d_model) // p * ssm.d_state * ssm.head_dim)
        elif kind == "rec":
            w = cfg.rglru.width(cfg.d_model)
            n += cfg.rglru.conv_kernel * w + w
    return 4 * rows * n


def _serve_launches(cfg, log: dict, p: int) -> dict:
    """The kernels' launches of a served run on one rank of a model group
    of ``p``: every norm of a prefill or a decode step
    (``norms_per_forward``), one flash launch per attention layer of each
    prefill this rank ran within the window."""
    from repro_torch.models.transformer import flash_per_prefill, norms_per_forward

    prompts = {i: n for i, (n, _) in enumerate(_dist_serve_shapes(cfg))}
    return {"rmsnorm": norms_per_forward(cfg, p) * (len(log["prefill"]) + len(log["decode"])),
            "flash": sum(flash_per_prefill(cfg, prompts[rid]) for rid in log["prefill"])}


def _rel(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()) / float(ref.float().abs().max())


def _held_to_serial(serial: dict, log: dict, tokens: dict, runner, routes=None,
                    prefill_routes=None) -> dict:
    """A served run's logits against the serial run's: every prefill this
    rank ran, and each decode row of this rank's slots while the request's
    tokens so far equal the serial ones (the step's inputs are the same)
    and, with ``routes`` (``_moe_routes`` of both runs), while its
    routed experts are the serial ones: each row where they differ is
    listed as (request, step, the serial router's margin there), and the
    worst logits of those rows kept apart, not held. ``prefill_routes``
    ({rid: the prompt's last token's experts [MoE layers, k]}) does the
    same for each prefill: one whose last token's routed experts differ in
    a MoE layer from the serial run's (its last routing call of that
    layer) is listed as (request, "prefill", margin), its logits kept
    apart, and its decode rows are not held."""
    first, rows = runner.first, runner.rows
    decode_rel, compared, flips, flipped_rel, parted = 0.0, 0, [], 0.0, set()
    prefill_rel = 0.0
    for rid, logits in log["prefill"].items():
        rel = _rel(logits, serial["prefill"][rid])
        if prefill_routes is not None:
            calls = serial["prefill_routes"][rid]
            c = len(calls) // len(prefill_routes[rid])  # serial calls a MoE layer
            moved = [m for (ti, m), tg in zip(calls[c - 1::c], prefill_routes[rid])
                     if sorted(ti.tolist()) != sorted(tg.tolist())]
            if moved:
                flips.append((rid, "prefill", max(moved)))
                flipped_rel = max(flipped_rel, rel)
                parted.add(rid)
                continue
        prefill_rel = max(prefill_rel, rel)
    for i, (got, active) in enumerate(zip(log["decode"], log["active"])):
        for slot, rid, n in active:
            if not (first <= slot < first + rows and rid not in parted
                    and tokens[rid][:n] == serial["tokens"][rid][:n]):
                continue
            rel = _rel(got[slot - first], serial["decode"][i, slot])
            moved = [] if routes is None else [
                float(margin[slot]) for (ti, margin), (tg, _) in zip(serial["routes"][i], routes[i])
                if sorted(ti[slot].tolist()) != sorted(tg[slot - first].tolist())]
            if moved:
                flips.append((rid, i, max(moved)))
                flipped_rel = max(flipped_rel, rel)
                parted.add(rid)
                continue
            decode_rel = max(decode_rel, rel)
            compared += 1
    return {"tokens_equal": tokens == serial["tokens"],
            "equal_tokens": sum(a == b for rid in tokens
                                for a, b in zip(tokens[rid], serial["tokens"][rid])),
            "all_tokens": sum(len(t) for t in serial["tokens"].values()),
            "prefill_rel": prefill_rel, "decode_rel": decode_rel, "compared": compared,
            "flips": flips,
            "flipped_rel": flipped_rel}


def _dist_serve_gate(arch: str, groups, sp: bool, quant: bool, serial: dict, device,
                     cut: bool) -> dict:
    """The requests through ``Engine(policy=)`` on this rank's shards, f32
    activations and f32 caches (the prefix int8 under ``quant``): tokens,
    prefill and decode logits held against the serial run's (each decode
    row while the request's tokens so far equal the serial ones), the
    kernels' launches, the flushes, the prefix bytes held; with ``cut``
    also one step with the sequence-sharded combine's sum cut."""
    import torch

    import repro_torch.models.attention as attn_lib
    from repro_torch.models import ParallelPolicy
    from repro_torch.serve import Engine

    cfg = _dist_serve_cfg(arch, "float32")
    pol = ParallelPolicy(mesh=groups, seq_shard=sp, kv_quant=quant)
    local = _drawn_shards(cfg, pol, device)

    def serve(max_tokens=None):
        engine = Engine(cfg, local, max_len=_dist_serve_max_len(cfg), max_batch=DIST_SERVE_SLOTS,
                        device=device, policy=pol, cache_dtype=torch.float32)
        log = {"prefill": {}, "decode": [], "active": []}
        for req in _dist_serve_requests(cfg):
            req.max_tokens = max_tokens or req.max_tokens
            engine.submit(req)
        _zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _serve_log(engine, log):
            done = engine.run_until_done()
        torch.cuda.synchronize()
        return engine, log, {r.rid: list(r.output) for r in done}, time.perf_counter() - t0

    engine, log, tokens, wall = serve()
    launched, runner = _kernel_counts(), engine.runner
    first, rows = runner.first, runner.rows
    out = {**_held_to_serial(serial, log, tokens, runner), "launches": launched,
           "want": _serve_launches(cfg, log, pol.model_size()), "flushes": runner.flushes,
           "prefix_bytes": _prefix_bytes(runner.cache), "state_bytes": _state_bytes(runner.cache),
           "rows": rows, "wall_s": wall, "prefills": len(log["prefill"]),
           "steps": len(log["decode"])}
    del engine, log
    if cut:  # the first decode step with each rank's own chunk only
        saved = attn_lib.all_reduce_sum
        attn_lib.all_reduce_sum = lambda x, group: x
        try:
            engine, log, _, _ = serve(max_tokens=2)
        finally:
            attn_lib.all_reduce_sum = saved
        got, active = log["decode"][0], log["active"][0]
        # a chunk that holds none of a row's keys divides 0 by 0 on its own
        rels = [_rel(got[slot - first], serial["decode"][0, slot])
                for slot, _, _ in active if first <= slot < first + rows]
        out["cut_rel"] = max(r if np.isfinite(r) else float("inf") for r in rels)
        del engine, log
    del local
    _free_cuda()
    return out


def _dist_serve_timed(arch: str, groups, serial: dict, device) -> dict:
    """The requests through ``Engine(policy=)`` in bf16 (weights and the
    reference's bf16 caches) on (1 x 4) with seq_shard: each prefill's and
    decode step's wall time (each ends in a read of the chosen tokens),
    decoded tokens, peak memory, the logits held against the serial bf16
    run's (``_held_to_serial``); then the same traffic with every
    collective timed (``core.collectives.timed``: each waits for the card
    before and after), for their share of the run."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.core.partition import gather_dim
    from repro_torch.launch.comm_analysis import collective_stats
    from repro_torch.models import ParallelPolicy
    from repro_torch.serve import Engine

    cfg = _dist_serve_cfg(arch, "bfloat16")
    pol = ParallelPolicy(mesh=groups, seq_shard=True)
    local = _drawn_shards(cfg, pol, device)
    out = {}
    for timed in (False, True):
        engine = Engine(cfg, local, max_len=_dist_serve_max_len(cfg), max_batch=DIST_SERVE_SLOTS,
                        device=device, policy=pol)
        log = {"prefill": {}, "decode": [], "active": []}
        for req in _dist_serve_requests(cfg, DIST_SERVE_TIMED_TOKENS):
            engine.submit(req)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        ctx = collectives.timed() if timed else contextlib.nullcontext()
        t0 = time.perf_counter()
        routes, prefills = [], []
        with ctx as count, _serve_log(engine, log), _moe_routes(routes, prefills):
            done = engine.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runner = engine.runner
        if timed:
            out.update(collectives_s=count["seconds"], collectives_calls=count["calls"],
                       timed_wall_s=wall, wire=collective_stats(count["ops"]).to_dict())
        else:
            last = None
            if cfg.moe is not None:  # the last model rank's last rows: the prompts' last tokens
                mine = torch.stack([torch.stack([t for t, _ in calls]) for calls in prefills])
                last = dict(zip(log["prefill"], gather_dim(mine[None], 0, pol.model_group)[-1]))
            out.update(_held_to_serial(serial, log, {r.rid: list(r.output) for r in done}, runner,
                                       routes, last))
            out.update(prefill_s=list(runner.prefill_s), decode_s=list(runner.decode_s),
                       tokens=sum(len(a) for a in log["active"]), wall_s=wall,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       prefix_bytes=_prefix_bytes(runner.cache),
                       state_bytes=_state_bytes(runner.cache), launches=_kernel_counts(),
                       want=_serve_launches(cfg, log, pol.model_size()))
        del engine, log
    del local
    _free_cuda()
    return out


def _dist_serve_kernel_times(gpu: str) -> dict:
    """Both kernels at the shard shapes serving gives a rank on (1 x 4),
    bf16: flash at each arch's prefill of 1536 tokens on the rank's heads,
    RMSNorm on the decode rows and on a seq_shard prompt's rows; held to
    the plain versions and timed by device time beside their bound and the
    library call (SDPA, ``F.rms_norm``)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(DIST_SERVE_SEED + 1)

    def randn(shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    s = max(n for n, _ in DIST_SERVE_REQUESTS)
    flash = {}
    for name, (h, kvh, hd) in {
            f"gemma-7b 1x4 prefill (b 1, s {s}, 4 heads x 256)": (4, 4, 256),
            f"chatglm3-6b 1x4 prefill (b 1, s {s}, 8 q heads, kv 1, x 128)": (8, 1, 128),
            f"deepseek-moe-16b 1x4 prefill (b 1, s {s}, 4 heads x 128)": (4, 4, 128),
            # MLA: dh_nope + dh_rope, v padded to it
            f"deepseek-v2-lite-16b MLA 1x4 prefill (b 1, s {s}, 4 heads x 192)": (4, 4, 192),
            # 10 heads padded to 12: 3 a rank, the padded rank one kv head a q head
            f"recurrentgemma-2b 1x4 prefill (b 1, s {s}, 3 q heads, kv 1, x 256)": (3, 1, 256),
            f"recurrentgemma-2b 1x4 prefill, padded rank (b 1, s {s}, 3 q heads, kv 3, x 256)": (
                3, 3, 256),
    }.items():
        q = randn((1, s, h, hd)).transpose(1, 2)
        k, v = (randn((1, s, kvh, hd)).transpose(1, 2) for _ in range(2))
        err = _lm_check(f"dist serve lm flash {name}", flash_attention(q, k, v),
                        flash_attention_ref(q, k, v))
        ms, by_ms = device_ms(lambda: flash_attention(q, k, v), n=10)
        plain, by_plain = device_ms(lambda: flash_attention_ref(q, k, v), n=5)
        lib, by_lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal_lower_right(s, s), enable_gqa=True), n=10)
        bound, by = _flash_bound_ms(1, h, kvh, s, s, hd, True, 2)
        print(f"[dist serve lm] flash {name}, device time: kernel {ms:.4f} ms, plain {plain:.4f} "
              f"ms, SDPA {lib:.4f} ms (kernel / SDPA {ms / lib:.2f}), bound {bound * 1e3:.2f} us "
              f"({by}); {gpu}")
        flash[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                           bound_by=by, timed_by={"ms": by_ms, "plain_ms": by_plain,
                                                  "library_ms": by_lib})
        del q, k, v
    rms = {}
    shapes = {}
    for arch in DIST_SERVE_ARCHS:
        cfg = _dist_serve_cfg(arch, "bfloat16")
        d = cfg.d_model
        shapes[f"{arch} 1x4 decode rows [{DIST_SERVE_SLOTS}, {d}]"] = (DIST_SERVE_SLOTS, d)
        shapes[f"{arch} 1x4 seq_shard prompt rows [{s // 4}, {d}]"] = (s // 4, d)
        if cfg.mla is not None:  # kv_norm, on the whole prompt on every rank
            lora = cfg.mla.kv_lora
            shapes[f"{arch} kv_norm decode rows [{DIST_SERVE_SLOTS}, {lora}]"] = (
                DIST_SERVE_SLOTS, lora)
            shapes[f"{arch} kv_norm prompt rows [{s}, {lora}]"] = (s, lora)
    for name, (rows, d) in shapes.items():
        x, w = randn((rows, d)), 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        err = _lm_check(f"dist serve lm rmsnorm {name}", rmsnorm(x, w), rmsnorm_ref(x, w))
        ms, by_ms = device_ms(lambda: rmsnorm(x, w))
        plain, by_plain = device_ms(lambda: rmsnorm_ref(x, w))
        lib, by_lib = device_ms(lambda: F.rms_norm(x.float(), (d,), w, eps=1e-6).to(x.dtype))
        bound, by = _rmsnorm_bound_ms(rows, d, 2)
        print(f"[dist serve lm] rmsnorm {name} bf16, device time: kernel {ms * 1e3:.2f} us "
              f"({bound / ms:.0%} of bound), plain {plain * 1e3:.2f} us, F.rms_norm "
              f"{lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({by}); {gpu}")
        rms[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by, timed_by={"ms": by_ms, "plain_ms": by_plain,
                                                "library_ms": by_lib})
    _free_cuda()
    return {"flash": flash, "rmsnorm": rms}


def _dist_serve_runs(arch: str) -> list:
    """(layout, seq_shard, kv_quant) of ``arch``'s gate runs."""
    runs = [(name, sp, False) for name, _, sp in DIST_SERVE_LAYOUTS]
    if arch in (DIST_SERVE_EXTRA, SSM_ARCH, HYBRID_ARCH):
        runs.append(("4x1", False, False))
    if arch == DIST_SERVE_EXTRA:
        runs.append(("1x4", True, True))
    return runs


def _dist_serve_rank(rank, world_size, device, job):
    """One rank of phase `dist serve lm` (``_dist_serve_rank_work``); drops
    its references to the job's CUDA tensors (the parent's, by CUDA IPC)
    before it returns."""
    import gc

    import torch

    try:
        return _dist_serve_rank_work(rank, world_size, device, job)
    finally:
        job.clear()
        gc.collect()
        torch.cuda.synchronize()


def _dist_serve_rank_work(rank, world_size, device, job):
    """Every arch's gate runs, the bf16 timed runs, then on rank 0 alone
    (the others wait) both kernels timed at the shard shapes."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import build_lm_groups

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    groups = {name: build_lm_groups(world_size, p) for name, p in (("1x4", 4), ("2x2", 2),
                                                                   ("4x1", 1))}
    out = {"gates": {}, "timed": {}}
    for arch in DIST_SERVE_ARCHS:
        for layout, sp, quant in _dist_serve_runs(arch):
            out["gates"][arch, layout, quant] = _dist_serve_gate(
                arch, groups[layout], sp, quant, job["serial"][arch, layout], device,
                cut=(arch, layout) in DIST_SERVE_CUTS and not quant)
    for arch in DIST_SERVE_ARCHS:
        out["timed"][arch] = _dist_serve_timed(arch, groups["1x4"], job["serial"][arch, "bf16"],
                                               device)
    out["whisper"] = _dist_whisper_serve_rank(groups, job, device)
    if rank == 0:
        out["times"] = _dist_serve_kernel_times(job["gpu"])
        out["times"]["flash"].update(_whisper_flash_times(
            {f"{layout} decode-step cross": shape
             for layout, shape in WHISPER_DIST_DECODE_FLASH.items()}, "dist serve lm", job["gpu"]))
        _free_cuda()
    dist.barrier()
    return out


def _dist_serve_check(ranks, gpu: str) -> dict:
    """Every rank's gate runs: tokens equal (f32 caches), logits within
    the gates, exactly one flush, the launches exact, a cut combine
    refused; prints the prefix bytes a rank holds against the serial
    cache's. Returns the launches summed over the gate runs and what is
    recorded."""
    from repro_torch.models.transformer import attention_layers

    out, launches = {}, {"rmsnorm": 0, "flash": 0}
    for key in ranks[0]["gates"]:
        arch, layout, quant = key
        cfg = _dist_serve_cfg(arch, "float32")
        runs = [r["gates"][key] for r in ranks]
        tag = f"{arch} on {layout}{' kv_quant' if quant else ''}"
        tol = DIST_SERVE_INT8 if quant else DIST_SERVE_F32
        faults = [f"rank {r}: launches {g['launches']}, want {g['want']}"
                  for r, g in enumerate(runs) if g["launches"] != g["want"]]
        # one flush where the attention caches have a tail (no window, no SSM)
        flushes = int(cfg.window is None and cfg.family != "ssm")
        faults += [f"rank {r}: {g['flushes']} flushes, want {flushes}" for r, g in enumerate(runs)
                   if g["flushes"] != flushes]
        faults += [f"rank {r}: tokens differ ({g['equal_tokens']} of {g['all_tokens']} equal)"
                   for r, g in enumerate(runs) if not quant and not g["tokens_equal"]]
        worst_p = max(g["prefill_rel"] for g in runs)
        worst_d = max(g["decode_rel"] for g in runs)
        if not worst_p <= DIST_SERVE_F32:
            faults.append(f"prefill logits {worst_p:.3e} of max|ref|")
        if not worst_d <= tol:
            faults.append(f"decode logits {worst_d:.3e} of max|ref|")
        d = int(layout.split("x")[0])
        p = DIST_RANKS // d
        # the serial engine's bf16 prefix: every slot, every kv head, S positions
        # (a window's ring: min(max_len, window) slots), k and v (MLA: the latent
        # and the RoPE key of every position), of every attention layer
        width = (cfg.mla.kv_lora + cfg.mla.dh_rope if cfg.mla is not None
                 else 2 * cfg.kv_heads * cfg.head_dim_)
        length = min(_dist_serve_max_len(cfg), cfg.window or DIST_SERVE_MAX_LEN)
        serial_bf16 = attention_layers(cfg) * DIST_SERVE_SLOTS * length * width * 2
        held = runs[0]["prefix_bytes"]
        # f32 prefixes twice bf16's; int8 with a bf16 scale per head dim's values
        expect = ((cfg.head_dim_ + 2) / (2 * cfg.head_dim_) if quant else 2.0) / p
        if any(abs(g["prefix_bytes"] - expect * serial_bf16 / d) > 1e-9 * serial_bf16
               for g in runs):
            faults.append(f"prefix bytes per rank {[g['prefix_bytes'] for g in runs]}, not "
                          f"{expect:.4f} of the serial bf16 cache's {serial_bf16 / d} for its rows")
        state = _rank_state_bytes(cfg, p, DIST_SERVE_SLOTS // d)
        if any(g["state_bytes"] != state for g in runs):
            faults.append(f"recurrent cache bytes per rank {[g['state_bytes'] for g in runs]}, "
                          f"not {state}")
        print(f"[dist serve lm] {tag}: tokens {'equal' if runs[0]['tokens_equal'] else 'differ'} "
              f"({runs[0]['equal_tokens']} of {runs[0]['all_tokens']} equal); prefill logits "
              f"{worst_p:.3e}, decode logits {worst_d:.3e} of max|ref| (gates {DIST_SERVE_F32}, "
              f"{tol}; {sum(g['compared'] for g in runs)} decode rows held over the ranks); "
              f"flushes {[g['flushes'] for g in runs]}; launches per rank "
              f"{[g['launches'] for g in runs]} (exact); a rank holds "
              f"{held / 2**20:.1f} MiB of prefix ({'int8 + bf16 scales' if quant else 'f32'}) for "
              f"its {runs[0]['rows']} slot rows: {held / max(serial_bf16 / d, 1):.4f} of the serial "
              f"bf16 cache's for those rows (P = {p}; 1/P at bf16), and "
              f"{runs[0]['state_bytes'] / 2**20:.2f} MiB of recurrent caches (f32: the SSM state "
              f"1/P, the convs and the RG-LRU's h whole); served in "
              f"{max(g['wall_s'] for g in runs):.2f}s; {gpu}")
        if "cut_rel" in runs[0]:
            cut = max(g["cut_rel"] for g in runs)
            print(f"[dist serve lm] {tag} with the combine's sum cut: the first decode step's "
                  f"logits {cut:.3e} of max|ref| from the serial ones (gate {tol}): refused")
            if cut <= tol:
                faults.append("a cut combine passed the gate")
        if faults:
            raise SystemExit(f"[dist serve lm] {tag}: " + "; ".join(faults[:8]))
        for k in launches:
            launches[k] += runs[0]["launches"][k]
        out[tag] = {"prefill_rel": worst_p, "decode_rel": worst_d,
                    "tokens_equal": runs[0]["tokens_equal"], "prefix_bytes": held,
                    "state_bytes": runs[0]["state_bytes"], "launches": runs[0]["launches"]}
    return {"launches": launches, "gates": out}


def _dist_serve_report_timed(ranks, gpu: str) -> dict:
    out, launches = {}, {"rmsnorm": 0, "flash": 0}
    for arch in DIST_SERVE_ARCHS:
        runs = [r["timed"][arch] for r in ranks]
        faults = [f"rank {r}: launches {t['launches']}, want {t['want']}"
                  for r, t in enumerate(runs) if t["launches"] != t["want"]]
        worst_p = max(t["prefill_rel"] for t in runs)
        worst_d = max(t["decode_rel"] for t in runs)
        if not worst_p <= DIST_SERVE_BF16:
            faults.append(f"prefill logits {worst_p:.3e} of max|ref|")
        if not worst_d <= DIST_SERVE_BF16:
            faults.append(f"decode logits {worst_d:.3e} of max|ref|")
        flips = [f for t in runs for f in t["flips"]]
        faults += [f"request {rid} step {i}: routed experts differ at a router margin {m:.3e}"
                   for rid, i, m in flips if not m <= DIST_SERVE_NEAR_TIE]
        print(f"[dist serve lm] bf16 {arch} on 1x4 seq_shard against the serial bf16 Engine: "
              f"prefill logits {worst_p:.3e}, decode logits {worst_d:.3e} of max|ref| (gate "
              f"{DIST_SERVE_BF16}; {sum(t['compared'] for t in runs)} decode rows held over the "
              f"ranks, each up to its request's first differing token or routed expert); "
              f"tokens {runs[0]['equal_tokens']} of {runs[0]['all_tokens']} equal; routed-expert "
              f"flips {len(runs[0]['flips'])} on rank 0 (serial router margins "
              f"{sorted(round(m, 6) for _, _, m in runs[0]['flips'])}, gate "
              f"{DIST_SERVE_NEAR_TIE} on every rank; their "
              f"rows' logits {max((t['flipped_rel'] for t in runs), default=0.0):.3e} of "
              f"max|ref|, not gated); {gpu}")
        if faults:
            raise SystemExit(f"[dist serve lm] bf16 {arch}: " + "; ".join(faults))
        for r, t in enumerate(runs):
            pre = [s * 1e3 for s in t["prefill_s"]]
            step = [s * 1e3 for s in t["decode_s"][1:]]
            share = t["collectives_s"] / t["timed_wall_s"]
            print(f"[dist serve lm] bf16 {arch} on 1x4 seq_shard, rank {r}: prefix "
                  f"{t['prefix_bytes'] / 2**20:.1f} MiB (bf16, 1/4 of the serial cache's), "
                  f"recurrent caches {t['state_bytes'] / 2**20:.2f} MiB (f32); prefills "
                  f"{[round(x, 1) for x in pre]} ms (prompts "
                  f"{[n for n, _ in _dist_serve_shapes(_dist_serve_cfg(arch, 'bfloat16'))]}), "
                  f"decode step {np.mean(step):.2f} ms (median {np.median(step):.2f}, "
                  f"{len(step)} steps after the first, {t['decode_s'][0] * 1e3:.1f} ms); "
                  f"{t['tokens'] / sum(t['decode_s']):.1f} decoded tok/s; collectives "
                  f"{t['collectives_s'] * 1e3:.1f} ms ({t['collectives_calls']} calls) of a "
                  f"{t['timed_wall_s'] * 1e3:.1f} ms run with each one timed ({share:.1%}), "
                  f"{_wire_words(t['wire'])}; peak {t['peak_gib']:.2f} GiB; {gpu}")
        for k in launches:
            launches[k] += runs[0]["launches"][k]
        t = runs[0]
        out[arch] = {"prefill_ms": [s * 1e3 for s in t["prefill_s"]],
                     "decode_step_ms": float(np.mean(t["decode_s"][1:]) * 1e3),
                     "tokens_per_s": t["tokens"] / sum(t["decode_s"]),
                     "collectives_share": [r["collectives_s"] / r["timed_wall_s"] for r in runs],
                     "wire_bytes": t["wire"]["total_bytes"],
                     "peak_gib": [r["peak_gib"] for r in runs], "prefix_bytes": t["prefix_bytes"],
                     "state_bytes": t["state_bytes"],
                     "prefill_rel": worst_p, "decode_rel": worst_d,
                     "equal_tokens": t["equal_tokens"], "flips": t["flips"],
                     "flipped_rel": max(r["flipped_rel"] for r in runs)}
    return {"launches": launches, "timed": out}


def _dist_serve_references(gpu: str, dev) -> dict:
    """{(arch, layout): the serial f32 run} of every gate run's layout: one
    run an arch, or for the MoE one a layout (its prompts' routing); and
    {(arch, "bf16"): the serial bf16 run} for the timed runs on (1 x 4)."""
    serial = {}
    for arch in DIST_SERVE_ARCHS:
        moe = _dist_serve_cfg(arch, "float32").moe is not None
        shared = None if moe else _dist_serve_serial(arch, 1, gpu, dev)
        for layout, _, _ in _dist_serve_runs(arch):
            p = DIST_RANKS // int(layout.split("x")[0])
            serial[arch, layout] = _dist_serve_serial(arch, p, gpu, dev) if moe else shared
        serial[arch, "bf16"] = _dist_serve_serial(arch, DIST_RANKS, gpu, dev, "bfloat16",
                                                  DIST_SERVE_TIMED_TOKENS)
    return serial


# ---------------------------------------------------------------------------
# whisper-tiny served over the ranks in phase `dist serve lm`: full width and
# depth, its caches by the rank's padded heads; f32 against the serial run
# on the card, bf16 timed on (1 x 4)
# ---------------------------------------------------------------------------

WHISPER_SERVE_PROMPT, WHISPER_SERVE_STEPS = 4, DIST_SERVE_TIMED_TOKENS
WHISPER_SERVE_LAYOUTS = (("1x4", True), ("2x2", False), ("4x1", False))
WHISPER_SERVE_F32 = 1e-5  # of max|ref|: served logits over the ranks against the serial run's


def _whisper_serve_inputs(cfg, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(WHISPER_DIST_SEED + 3)
    frames = torch.randn((WHISPER_DIST_BATCH, cfg.encoder.frames, cfg.d_model), generator=gen,
                         device=device)
    prompt = torch.randint(1, cfg.vocab, (WHISPER_DIST_BATCH, WHISPER_SERVE_PROMPT), generator=gen,
                           device=device)
    return frames, prompt


def _whisper_greedy(params, frames, prompt, cfg, pol, cache_dtype, clock=None):
    """A prefill and ``WHISPER_SERVE_STEPS`` greedy decode steps: the logits
    of every step [steps + 1, b, V], the tokens [b, steps + 1], the cache;
    with ``clock`` (a list) each call's wall time, ending in a read of the
    chosen tokens."""
    import torch

    from repro_torch.models import whisper_decode_step, whisper_prefill

    max_len = WHISPER_SERVE_PROMPT + WHISPER_SERVE_STEPS
    t0 = time.perf_counter()
    logits, cache = whisper_prefill(params, prompt, frames, cfg, max_len=max_len, policy=pol,
                                    cache_dtype=cache_dtype)
    tok = torch.argmax(logits, -1)[:, None]
    outs, toks = [logits], [tok.cpu()]
    if clock is not None:
        clock.append(time.perf_counter() - t0)
    for i in range(WHISPER_SERVE_STEPS):
        t0 = time.perf_counter()
        logits, cache = whisper_decode_step(params, tok, cache, WHISPER_SERVE_PROMPT + i, cfg, pol)
        tok = torch.argmax(logits, -1)[:, None]
        toks.append(tok.cpu())
        if clock is not None:
            clock.append(time.perf_counter() - t0)
        outs.append(logits)
    return torch.stack(outs), torch.cat(toks, 1), cache


def _dist_whisper_serve_serial(gpu: str, dev) -> dict:
    """The serial f32 whisper-tiny run on the card (f32 weights, f32
    caches): every step's logits and the tokens."""
    import torch

    from repro_torch.models import LOCAL

    cfg = _whisper_dist_cfg("float32")
    params = _whisper_dist_params(cfg, dev)
    frames, prompt = _whisper_serve_inputs(cfg, dev)
    with torch.inference_mode():
        logits, toks, _ = _whisper_greedy(params, frames, prompt, cfg, LOCAL, torch.float32)
    print(f"[dist serve lm] serial {cfg.name} f32: batch {WHISPER_DIST_BATCH}, "
          f"{WHISPER_SERVE_PROMPT}-token prompts, {WHISPER_SERVE_STEPS} greedy steps; {gpu}")
    return {"logits": logits.clone(), "tokens": toks.clone()}  # clones leave inference mode


def _dist_whisper_serve(groups, sp: bool, serial: dict, device) -> dict:
    """The f32 run over the ranks on ``serving_heads`` of this rank's
    shards and its rows, f32 caches: the logits of its rows against the
    serial run's, the tokens, flash's launches, the bytes of its shards
    and cache, its peak memory."""
    import torch

    from repro_torch.models import ParallelPolicy
    from repro_torch.models.whisper import serving_heads

    cfg = _whisper_dist_cfg("float32")
    pol = ParallelPolicy(mesh=groups, seq_shard=sp)
    torch.cuda.reset_peak_memory_stats()
    local = _whisper_local(cfg, pol, device)
    rows = WHISPER_DIST_BATCH // pol.dp_size()
    lo = pol.data_rank() * rows
    frames, prompt = _whisper_serve_inputs(cfg, device)
    with torch.inference_mode():
        served = serving_heads(local, cfg, pol)
        _zero_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, toks, cache = _whisper_greedy(served, frames[lo:lo + rows], prompt[lo:lo + rows],
                                              cfg, pol, torch.float32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _kernel_counts()
    ref = serial["logits"][:, lo:lo + rows]
    out = {"rel": _rel(logits, ref), "tokens_equal": bool(torch.equal(toks, serial["tokens"][lo:lo + rows])),
           "launches": launched, "wall_s": wall, "param_bytes": _tree_bytes(local),
           "cache_bytes": _tree_bytes(cache), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "finite": _finite(logits)}
    del local, served, cache
    _free_cuda()
    return out


def _dist_whisper_serve_timed(groups, device) -> dict:
    """bf16 serving on (1 x 4) with seq_shard (the serving draw's weights,
    the reference's bf16 caches): each call's wall time, then the same
    traffic with every collective timed (share, bytes on the wire); the
    cache's bytes, the shards' bytes, peak memory."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.launch.comm_analysis import collective_stats
    from repro_torch.models import ParallelPolicy
    from repro_torch.models.whisper import serving_heads

    cfg = _whisper_dist_cfg("bfloat16")
    pol = ParallelPolicy(mesh=groups, seq_shard=True)
    local = _whisper_local(cfg, pol, device, serving=True)
    frames, prompt = _whisper_serve_inputs(cfg, device)
    out = {"param_bytes": _tree_bytes(local)}
    with torch.inference_mode():
        served = serving_heads(local, cfg, pol)
        _whisper_greedy(served, frames, prompt, cfg, pol, torch.bfloat16)  # warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clock = []
        _zero_kernel_counts()
        logits, toks, cache = _whisper_greedy(served, frames, prompt, cfg, pol, torch.bfloat16,
                                              clock)
        out.update(launches=_kernel_counts(), prefill_s=clock[0], decode_s=clock[1:],
                   cache_bytes=_tree_bytes(cache), finite=_finite(logits),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del cache
        with collectives.timed() as count:
            t0 = time.perf_counter()
            _whisper_greedy(served, frames, prompt, cfg, pol, torch.bfloat16)
            torch.cuda.synchronize()
            out.update(timed_wall_s=time.perf_counter() - t0, collectives_s=count["seconds"],
                       collectives_calls=count["calls"],
                       wire=collective_stats(count["ops"]).to_dict())
    del local, served
    _free_cuda()
    return out


def _dist_whisper_serve_rank(groups: dict, job: dict, device) -> dict:
    out = {"gates": {layout: _dist_whisper_serve(groups[layout], sp, job["whisper"], device)
                     for layout, sp in WHISPER_SERVE_LAYOUTS}}
    out["timed"] = _dist_whisper_serve_timed(groups["1x4"], device)
    return out


def _dist_whisper_serve_check(ranks, gpu: str) -> dict:
    """Every rank's f32 run: tokens equal to the serial run's, logits within
    ``WHISPER_SERVE_F32`` of max|ref|, flash's launches exact (a prefill's
    and a decode step's each); then the bf16 timing."""
    from repro_torch.models.whisper import flash_per_prefill

    cfg = _whisper_dist_cfg("float32")
    want = {"rmsnorm": 0, "flash": flash_per_prefill(cfg) + WHISPER_SERVE_STEPS * cfg.n_layers}
    out = {}
    for layout, sp in WHISPER_SERVE_LAYOUTS:
        runs = [r["whisper"]["gates"][layout] for r in ranks]
        worst = max(g["rel"] for g in runs)
        faults = [f"rank {r}: launches {g['launches']}, want {want}" for r, g in enumerate(runs)
                  if g["launches"] != want]
        faults += [f"rank {r}: tokens differ" for r, g in enumerate(runs) if not g["tokens_equal"]]
        if not worst <= WHISPER_SERVE_F32 or not all(g["finite"] for g in runs):
            faults.append(f"logits {worst:.3e} of max|ref| (gate {WHISPER_SERVE_F32})")
        print(f"[dist serve lm] {WHISPER_ARCH} f32 on {layout}{' seq_shard' if sp else ''}: "
              f"tokens equal on every rank, prefill and {WHISPER_SERVE_STEPS} decode steps' "
              f"logits {worst:.3e} of max|ref| (gate {WHISPER_SERVE_F32}); launches per rank "
              f"{runs[0]['launches']} (exact); a rank holds {runs[0]['cache_bytes'] / 2**20:.2f} "
              f"MiB of f32 cache (its rows and padded heads) and {runs[0]['param_bytes'] / 2**20:.1f} "
              f"MiB of shards; served in {max(g['wall_s'] for g in runs):.2f}s; {gpu}"
              if not faults else f"[dist serve lm] {WHISPER_ARCH} on {layout}: {faults}")
        if faults:
            raise SystemExit(f"[dist serve lm] whisper on {layout}: " + "; ".join(faults[:8]))
        out[layout] = {"rel": worst, "launches": runs[0]["launches"],
                       "cache_bytes": [g["cache_bytes"] for g in runs],
                       "param_bytes": [g["param_bytes"] for g in runs],
                       "peak_gib": [g["peak_gib"] for g in runs]}
    timed = [r["whisper"]["timed"] for r in ranks]
    if any(t["launches"] != want or not t["finite"] for t in timed):
        raise SystemExit(f"[dist serve lm] whisper bf16: launches {[t['launches'] for t in timed]}, "
                         f"want {want}, or logits not finite")
    for r, t in enumerate(timed):
        step = [s * 1e3 for s in t["decode_s"][1:]]
        share = t["collectives_s"] / t["timed_wall_s"]
        print(f"[dist serve lm] {WHISPER_ARCH} bf16 on 1x4 seq_shard, rank {r}: prefill "
              f"{t['prefill_s'] * 1e3:.1f} ms (batch {WHISPER_DIST_BATCH}, {cfg.encoder.frames} "
              f"frames, {WHISPER_SERVE_PROMPT}-token prompts), decode step {np.mean(step):.2f} ms "
              f"(median {np.median(step):.2f}, {len(step)} steps after the first); collectives "
              f"{t['collectives_s'] * 1e3:.1f} ms ({t['collectives_calls']} calls) of a "
              f"{t['timed_wall_s'] * 1e3:.1f} ms run with each one timed ({share:.1%}), "
              f"{_wire_words(t['wire'])}; cache {t['cache_bytes'] / 2**20:.2f} MiB (bf16); peak "
              f"{t['peak_gib']:.2f} GiB; {gpu}")
    t = timed[0]
    out["timed"] = {"prefill_ms": t["prefill_s"] * 1e3,
                    "decode_step_ms": float(np.mean(t["decode_s"][1:]) * 1e3),
                    "collectives_share": [x["collectives_s"] / x["timed_wall_s"] for x in timed],
                    "wire_bytes": t["wire"]["total_bytes"], "cache_bytes": t["cache_bytes"],
                    "param_bytes": [x["param_bytes"] for x in timed],
                    "peak_gib": [x["peak_gib"] for x in timed], "launches": t["launches"]}
    return out


def phase_dist_serve_lm(gpu: str) -> dict:
    """LM serving at full width (``DIST_SERVE_ARCHS``, depth cut) on
    ``DIST_RANKS`` gloo ranks sharing this card: the serial Engine's f32
    runs on the card first (shared with the ranks by CUDA IPC), then one
    launch of the ranks (``_dist_serve_rank``): the gate runs of every arch
    on (1 x 4) and (2 x 2), one arch also on (4 x 1) and with kv_quant, a
    cut combine, the bf16 runs timed, both kernels at the shard shapes.
    Returns the launch counts and the measurements."""
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import launch_ranks
    from repro_torch.models.attention import TAIL_LEN

    _free_cuda()
    dev = torch.device("cuda")
    print(f"reduced: the flushed request's tokens 80 -> {DIST_SERVE_FLUSHED} (the script's "
          f"time; {DIST_SERVE_FLUSHED - 1 - TAIL_LEN} decode step past its tail flush)")
    print(f"reduced: the timed bf16 runs' tokens a request {DIST_SERVE_FLUSHED} -> "
          f"{DIST_SERVE_TIMED_TOKENS} at most (the script's time; "
          f"{DIST_SERVE_TIMED_TOKENS - 1} decode steps, the first not counted; no flush)")
    for arch, n in DIST_SERVE_ARCHS.items():
        full, cfg = get_arch(arch), _dist_serve_cfg(arch, "float32")
        print(f"reduced: {arch} layers {full.n_layers} -> {n} (kept: {_kept_layers(cfg)}; "
              f"{cfg.approx_params() / 1e9:.3f} B params; {cfg.n_heads} heads over "
              f"{cfg.kv_heads} kv heads x {cfg.head_dim_}, d_model {cfg.d_model}, vocab {cfg.vocab})")
    t0 = time.perf_counter()
    serial = _dist_serve_references(gpu, dev)
    whisper_serial = _dist_whisper_serve_serial(gpu, dev)
    _free_cuda()
    print(f"[dist serve lm] serial references on the card in {time.perf_counter() - t0:.1f}s; "
          f"{_memory_line()}")
    job = {"serial": serial, "gpu": gpu, "whisper": whisper_serial}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = launch_ranks(_dist_serve_rank, DIST_RANKS, d, args=(job,),
                             collective_timeout_s=DIST_TIMEOUT_S, deadline_s=DIST_TIMEOUT_S,
                             device="cuda")
    print(f"[dist serve lm] {DIST_RANKS} gloo ranks on one card: "
          f"{time.perf_counter() - t0:.1f}s for the launch")
    gates = _dist_serve_check(ranks, gpu)
    timed = _dist_serve_report_timed(ranks, gpu)
    whisper = _dist_whisper_serve_check(ranks, gpu)
    del job, serial, whisper_serial
    torch.cuda.ipc_collect()
    _free_cuda()
    launches = {k: gates["launches"][k] + timed["launches"][k] for k in ("rmsnorm", "flash")}
    whisper_launches = {k: sum(whisper[layout]["launches"][k] for layout, _ in WHISPER_SERVE_LAYOUTS)
                        + whisper["timed"]["launches"][k] for k in ("rmsnorm", "flash")}
    return {"launches": {"dist_serve_lm": launches, "dist_serve_whisper": whisper_launches},
            "gates": gates["gates"], "timed": timed["timed"], "times": ranks[0]["times"],
            "whisper": whisper}


# ---------------------------------------------------------------------------
# Phase `dryrun`: the dry-run tooling on the card's constants, and its
# per-rank bytes against what the ranks of the dist phases held
# ---------------------------------------------------------------------------

def phase_dryrun(gpu: str, dist: dict, dist_lm: dict, dist_serve: dict) -> dict:
    """``launch/dryrun.py --all`` (its artifacts in a temp dir; the card's
    memory for the fit check): the number of cells and how many fit. Then
    the dry-run's per-rank bytes against the bytes the ranks' tensors held,
    exactly: whisper-tiny's shards on (1 x 4) and (2 x 2) in `dist lm`
    (f32 masters), its shards and caches on every layout of `dist serve lm`
    (f32 shards and caches; bf16 serving draw and caches on (1 x 4)), the
    Sleipner FNO's shards on the P = 4 layout of phase `dist`; each rank's
    ``max_memory_allocated`` beside them."""
    import tempfile

    import torch

    from repro_torch.launch import dryrun

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(buf):
        dryrun.main(["--all", "--out-dir", d])
        n_files = len(os.listdir(d))
    last = buf.getvalue().strip().splitlines()[-1]
    m = re.search(r"(\d+) cells, (\d+) fit", last)
    if m is None or int(m.group(1)) != n_files or n_files != 2 * len(list(dryrun.iter_cells())):
        raise SystemExit(f"[dryrun] {last!r}: {n_files} artifacts")
    print(f"[dryrun] launch/dryrun.py --all on meshes 16x16 and 2x16x16 (pod folded into data): "
          f"{m.group(1)} cells, {m.group(2)} fit one card of "
          f"{dryrun.device_memory_bytes() / 2**30:.2f} GiB (the card's total_memory); {gpu}")
    w32, w16 = _whisper_dist_cfg("float32"), _whisper_dist_cfg("bfloat16")
    max_len = WHISPER_SERVE_PROMPT + WHISPER_SERVE_STEPS
    checks = []
    for name, p, _ in DIST_LM_LAYOUTS:
        run = dist_lm["whisper"][name]
        checks.append((f"dist lm {WHISPER_ARCH} {name} shards (f32 masters)",
                       dryrun.lm_param_bytes(w32, DIST_RANKS // p, p), run["param_bytes"],
                       run["peak_gib"]))
    for layout, _ in WHISPER_SERVE_LAYOUTS:
        run = dist_serve["whisper"][layout]
        d = int(layout.split("x")[0])
        p = DIST_RANKS // d
        checks.append((f"dist serve lm {WHISPER_ARCH} {layout} shards (f32)",
                       dryrun.lm_param_bytes(w32, d, p, serving=True), run["param_bytes"],
                       run["peak_gib"]))
        checks.append((f"dist serve lm {WHISPER_ARCH} {layout} cache (f32, batch "
                       f"{WHISPER_DIST_BATCH}, max_len {max_len})",
                       dryrun.lm_cache_bytes(w32, d, p, WHISPER_DIST_BATCH, max_len, torch.float32),
                       run["cache_bytes"], run["peak_gib"]))
    timed = dist_serve["whisper"]["timed"]
    checks.append((f"dist serve lm {WHISPER_ARCH} 1x4 shards (bf16 serving draw)",
                   dryrun.lm_param_bytes(w16, 1, DIST_RANKS, serving=True), timed["param_bytes"],
                   timed["peak_gib"]))
    checks.append((f"dist serve lm {WHISPER_ARCH} 1x4 cache (bf16)",
                   dryrun.lm_cache_bytes(w16, 1, DIST_RANKS, WHISPER_DIST_BATCH, max_len),
                   [timed["cache_bytes"]] * DIST_RANKS, timed["peak_gib"]))
    fno = dist["fno_p4"]
    checks.append(("dist Sleipner FNO 1 x 4 shards (w_spec by k_y)",
                   dryrun.fno_param_bytes(_serving_cfg(), {"model": DIST_RANKS}),
                   fno["param_bytes"], fno["peak_gib"]))
    out = {}
    for what, want, held, peaks in checks:
        print(f"[dryrun] {what}: the dry-run's {want} B a rank, the ranks held "
              f"{sorted(set(held))} B ({'equal' if set(held) == {want} else 'NOT EQUAL'}); "
              f"max_memory_allocated {[round(x, 2) for x in peaks]} GiB (activations and "
              f"workspace included); {gpu}")
        if set(held) != {want}:
            raise SystemExit(f"[dryrun] {what}: the ranks held {held} B, the dry-run says {want}")
        out[what] = {"bytes": want, "peak_gib": peaks}
    return {"cells": int(m.group(1)), "fit": int(m.group(2)), "checks": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gpu = gpu_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}; {gpu}")
    t0 = time.perf_counter()

    def phase(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f}s")
        return result

    phase("build", phase_build)
    fused = phase("kernels", phase_kernels, gpu)
    dx, dw = phase("backward kernels", phase_backward_kernels, gpu)
    fused.update(dx)
    flat, flat_dw = phase("flat kernels", phase_flat_kernels, gpu)
    served_launches, served_per_scen_s = phase("serve", phase_serving, gpu)
    served = {"serve": served_launches, **phase("ensemble", phase_ensemble, gpu),
              **phase("cli", phase_cli, gpu), **phase("fleet", phase_fleet, gpu)}
    rms, flash = phase("lm kernels", phase_lm_kernels, gpu)
    train = phase("train", phase_train, gpu)
    train_cli = phase("train cli", phase_train_cli, gpu)
    data = phase("data", phase_data, gpu, served_per_scen_s)
    dist = phase("dist", phase_dist, gpu)
    dist_train = phase("dist_train", phase_dist_train, gpu, dist)
    dist_cli = phase("dist_train cli", phase_dist_train_cli, gpu)
    lm = phase("lm serving", phase_lm_serving, gpu)
    moe = phase("moe serving", phase_moe_serving, gpu)
    recurrent = phase("recurrent serving", phase_recurrent_serving, gpu)
    whisper = phase("whisper serving", phase_whisper_serving, gpu)
    lm_cli = phase("lm cli", phase_lm_cli, gpu)
    lm_train = phase("lm train", phase_lm_train, gpu)
    dist_lm = phase("dist lm", phase_dist_lm, gpu)
    dist_serve = phase("dist serve lm", phase_dist_serve_lm, gpu)
    dry = phase("dryrun", phase_dryrun, gpu, dist, dist_lm, dist_serve)
    fused["launches"] = train["fused"]
    fused["launches_by_path"] = {
        **served, "train": train["fused"], "train_cli": train_cli["fused"],
        "train_cli_serve": train_cli["serve"], "ns3d_forward": data["ns3d_forward"],
        "online_train": data["online"]["fused"], "online_serve": data["online"]["serve"],
    }
    dw["launches"] = train["dw"]
    dw["launches_by_path"] = {"train": train["dw"], "train_cli": train_cli["dw"],
                              "online_train": data["online"]["dw"]}
    # the dist paths' launches as counted on rank 0 (every rank's were checked equal)
    for record, key in ((fused, "fused"), (dw, "dw")):
        record["launches_by_path"].update(
            {tag: n[key] for tag, n in {**dist["launches"], **dist_train}.items() if n[key]})
        record["launches_by_path"]["dist_train_cli"] = dist_cli[key]
        record["dist_ranks"] = DIST_RANKS
    fused["launches_by_path"]["dist_train_cli_serve"] = dist_cli["serve"]
    fused["launches_by_path"]["dist_train_cli_serve_4ranks"] = dist_cli["serve_4"]
    fused["dist_shapes"] = {k: v for k, v in dist["timed"].items() if not k.endswith("dW")}
    dw["dist_shapes"] = {k: v for k, v in dist["timed"].items() if k.endswith("dW")}
    moe_cli_archs, recurrent_archs = (MOE_ARCH, "deepseek-moe-16b"), (SSM_ARCH, HYBRID_ARCH)
    for record, key in ((rms, "rmsnorm"), (flash, "flash")):
        record["launches"] = lm[key]
        record["launches_by_path"] = {
            "lm_serve": lm[key], "lm_cli": lm_cli[LM_ARCH][key], "moe_serve": moe[key],
            "moe_cli": sum(lm_cli[arch][key] for arch in moe_cli_archs),
            "recurrent_serve": sum(recurrent[arch][key] for arch in recurrent_archs),
            "recurrent_cli": sum(lm_cli[arch][key] for arch in recurrent_archs),
            "whisper_serve": whisper[key]}
        record["recurrent_launches_by_arch"] = {
            arch: {"serve": recurrent[arch][key], "cli": lm_cli[arch][key]}
            for arch in recurrent_archs}
    flash["recurrent_serving"] = {arch: recurrent[arch]["stats"] for arch in recurrent_archs}
    flash["launches_by_path"]["whisper_loss"] = whisper["loss_flash"]
    flash["whisper_serving"] = whisper["stats"]
    for record, key in ((rms, "rmsnorm"), (flash, "flash")):
        record["launches_by_path"].update({
            "lm_train": lm_train["launches"][key], "whisper_train": lm_train["whisper_launches"][key],
            "lm_train_cli": sum(run[key] for run in lm_train["cli"].values())})
        record["backward"] = lm_train["backward"][key]
        record["launches_by_path"].update({path: n[key] for path, n in dist_lm["launches"].items()})
        record["dist_shapes"] = dist_lm["times"][key]
        record["launches_by_path"].update(
            {path: n[key] for path, n in dist_serve["launches"].items()})
        record["dist_serve_shapes"] = dist_serve["times"][key]
    flash["lm_train"] = lm_train["stats"]
    flash["dist_lm"] = {k: dist_lm[k] for k in ("gates", "ulysses", "step", "whisper")}
    flash["dist_serve_lm"] = {k: dist_serve[k] for k in ("gates", "timed", "whisper")}
    flash["dryrun"] = dry
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(gpu)
    print(json.dumps({"kernels": [fused, dw, flat, flat_dw, rms, flash]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
