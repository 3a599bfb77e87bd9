"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. card + kernel build: nvidia-smi name/power limit, nvcc build time of
     every ``src/repro_torch/kernels/csrc/*.cu``.
  2. kernels vs their plain PyTorch versions at the serving path's shapes
     (Hq=32, Hkv=8, D=64, page 16), fp32 and bf16, plus small mask cases:
     the global and the per-slot paged decode and flash prefill (bf16 also
     at head dims 128 and 256, on the wgmma kernel); CUDA-event times of
     kernel, plain version and the library yardstick, each kernel's bound,
     and the global decode's "hbm" table residency against "smem". The
     decode rows add the kernel's device time (torch.profiler), the time of
     calls enqueued back to back and the kernel launches a call, and both
     decode kernels are also timed at long context past the 50 MB L2
     (DECODE_LONG) and at phase 3e's serving shapes (DECODE_ARCHS:
     qwen2-7b's and llama3.2-3b's pools, gemma2-2b's pool and its rings,
     lengths past their capacity, softcap 50). Flash is also timed at 4096
     tokens in llama3.2-1b's, qwen2-7b's and gemma2-2b's widths, with its
     device time, and checked at phase 3e's prefill shapes (gemma2's
     8192 tokens with window 4096 and softcap 50). olmoe-1b-7b's shapes
     (16 query heads over 16 KV heads, D 128): its global and per-slot
     decode rows, and its prefill (8 x 512) timed on the wgmma kernel. The
     jamba's attention layer (64 query heads over 8 KV heads, G = 8, D
     128): its global and per-slot decode rows, its prefill (8 x 512)
     timed on the wgmma kernel, and held against the plain version at each
     exact-length prefill shape of phase 3g's serves. Flash without the
     causal mask at phase 3h's shapes, timed: seamless's encoder (8 x
     3072, 16/16, D 64), its cross prefill (8 x 512 over 3072) and its
     cross decode (one query row over 3072), llama-vision's cross prefill
     (8 x 512 over 4096 image tokens, 64/8, D 128) and its cross decode
     (one row over 4096); and held against the plain version where fewer
     query rows than one tile (Sq 1 to 33) reach either kernel and at every
     prefill shape of phase 3h's serves (the zero-copy bucket, each
     prompt's length at B 1, seamless's encoder at B 8 and 1). kimi-k2's
     head dim 112 on the wgmma kernel (two slabs, the second zero-padded):
     mask cases, phase 3i's prefill shapes, its bucket (8 x 512, 64/8)
     timed, and its global decode row (64/8, D 112). Flash is
     held to the smaller of the dtype's limit and 2e-2 of the plain
     output's largest value; every non-causal case over more than one KV
     tile also shows that the plain version with one tile of keys dropped
     misses that limit. The
     MoE FFN (no kernel of its own: batched matmuls) at olmoe's full width
     in bf16, index dispatch against the reference's one-hot einsums on a
     decode batch of 8 tokens and a right-padded prefill of 8 x 512: keep
     masks bit for bit, the error, times, the bound, and one call with the
     sync debug mode at "error" (no host sync). bf16 decode's
     precision in P: on a cancellation case (repro_torch/kernels/
     paged_attention/precision.py) the kernel's error against the fp32
     plain version must be within 1/16 of a plain decode's that rounds P to
     bf16.
  3. full-width llama3.2-1b (bf16, random seeded weights) served by the
     zero-copy paged engine: prefix sharing, CoW, launch counters (every
     flash launch a wgmma one).
  3c. the same requests served by the copy-mode engine (the staging
     baseline over per-slot pools), beside phase 3's figures.
  3d. the same requests served by the continuous engine (8 slots, a pool
     of half the pages the requests need at their end, shrunk until it
     preempts and resumes; max_len the longest request's) and by the
     disaggregated engine (4 prefill + 4 decode slots) in share and in
     copy mode (8 KV transfers each; share moves no page payload, copy
     does, and gives share's tokens): every masked decode launches the
     paged decode kernel once a layer, chunked prefill never launches
     flash.
  3e. the other dense decoders at full width, one at a time (bf16, depth
     not cut, random seeded weights): qwen2-7b, llama3.2-3b and gemma2-2b,
     whose sliding-window layers keep rings of 4096 tokens beside the
     global pool. Per arch: decode against prefill (llama3.2-1b the
     control; gemma2 at 4500 tokens, past its window), layer by layer,
     and end to end where the weights are not chaotic; a zero-copy serve
     (phase 3's requests, gemma2 four prompts of 4500-6000 tokens) whose
     launch counts must be one global decode a global layer a step and one
     per-slot decode a ring layer a step; its copy serves in turns (gemma2's
     copy mode must raise); and every request's first-token logits within
     5e-2 (relative to the largest logit) of a B=1 prefill.
  3f. olmoe-1b-7b at full width (bf16, 16 attn_moe layers, 64 experts
     top-8, depth not cut, random seeded weights): (a) decode against
     prefill layer by layer and end to end at capacity factor 16 (no
     choice drops; at the published 1.25 a decode batch of 2 tokens has
     C = 1 and drops what a prefill keeps); (b) a zero-copy serve of phase
     3's requests at the published capacity, one global decode launch a
     layer a step, flash on wgmma, the share of (token, choice) pairs
     dropped in prefill and in decode, then its copy serves in turns; (c)
     each request's first-token logits against a B=1 prefill, on a serve
     at capacity 16 (at 1.25 the batch's make-up changes which choices
     drop). Chaotic weights serve q/k-scaled, as in 3e.
  3g. the recurrent-state decoders (bf16, random seeded weights): rwkv6-3b
     as get_config gives it (32 rwkv layers, no attention), and jamba at
     full width on the first five layers of its period (mamba, mamba_moe,
     mamba, mamba_moe, attn: ~44 GiB; a whole period of 8 is 84 GiB).
     Per arch: (a) decode against prefill layer by layer (for a recurrent
     layer the chunked scan against the step recurrence) and end to end
     where not chaotic, jamba at capacity factor 16; (b) a zero-copy serve,
     then copy, copy, zero-copy in turns, at exact-length prefill (prompt
     lengths the reference's chunking takes: rwkv6 multiples of 32 in
     192-480, jamba under 512, two pairs of equal lengths, so 6 prefills
     for 8 requests in zero-copy): rwkv6 launches no attention kernel,
     jamba one global (copy: per-slot) decode a step and one flash a
     prefill; (c) each request's first-token logits against a B=1 prefill
     (jamba at capacity 16, where no choice drops), within 5e-2 for every
     request whose serve prefill chose the B=1 prefill's experts in every
     MoE layer; where one choice flipped, a reading beside the count of
     flipped tokens.
  3h. the cross-attention models (bf16, random seeded weights, every
     cross gate at 1.0, where the reference draws 0): seamless-m4t-medium
     as get_config gives it (a 12-layer encoder over 3072 frames, the
     reference's stub, and 12 cross_mlp decoder layers; ~1.6 GiB) and
     llama-vision at full width on its first two periods (8 attn_mlp, 2
     xattn_mlp over 4096 image tokens; ~20 GiB; all 100 layers are ~175
     GB). Per arch: (a) decode against prefill layer by layer and end to
     end (where not chaotic) over random encoder input or image
     embeddings; (b) a zero-copy serve of phase 3's requests, then copy,
     copy, zero-copy in turns (the engine feeds a zero source, as the
     reference's): one global (copy: per-slot) decode a self-attention
     layer a step, one flash a cross layer a step (the cross decode, Sq 1)
     and one an encoder, self- and cross-attention layer a prefill call
     (seamless 12 and 36, the vision cut 2 and 10), and each serve's peak
     GiB past what earlier phases keep resident; (c) each request's
     first-token logits within 5e-2 of a B=1 prefill; (d) for vision, the
     served (8, 512) bucket and the B=1 prefills of the two prompts whose
     (c) reads largest, a layer at a time (the residual stream at the
     last token), in bf16 as served, in bf16 with flash's plain version,
     and in fp32: the bucket's logits equal the serve's bit for bit, and
     the fp32 run's agree within 1e-3.
  3i. kimi-k2 at full width on its first two layers (bf16, random seeded
     weights: the dense first layer, attention 64/8 at D 112 and FFN
     16384; one attn_moe layer of 384 experts of d_ff 2048, top 8, a
     shared expert; the 163840-row table and head; ~37 GiB): (a) decode
     against prefill layer by layer and end to end at capacity factor 48
     (E / K: no choice drops at any batch size); (b) one zero-copy serve
     of phase 3's requests at the published capacity: no staging copy,
     one global decode a layer a step, one flash a layer a prefill call,
     every one on the wgmma kernel at D 112, the dropped shares, ms a
     step, TTFT, peak GiB; (c) each request's first-token logits against
     a B=1 prefill on a serve at capacity 16, within 5e-2 for every
     request whose last token took the same experts in both prefills.
  4. the smoke-reduced llama3.2-1b, qwen2-7b, llama3.2-3b, gemma2-2b,
     olmoe-1b-7b, kimi-k2-1t-a32b, rwkv6-3b, jamba, seamless-m4t-medium
     and llama-vision (at src_len 8, its smoke image tokens) (fp32) served
     on cuda and on cpu over
     the same seeded workload, in zero_copy and (but gemma2, which must
     refuse it) in copy mode; then llama3.2-1b, qwen2-7b and olmoe by the
     continuous engine (a pool of 8 pages: it preempts) and the
     disaggregated engine in share and copy mode: greedy tokens must be
     identical on cuda and cpu; for the dense archs copy must equal
     zero_copy without prefix sharing, and the three scheduled kinds must
     equal the fixed engine (an MoE arch's capacity depends on the batch,
     so for olmoe and kimi these are recorded, not asserted). gemma2's
     rings (window 8) wrap on the card through the fp32 kernels.
  5. the paper's kernels (gemm, gesummv, axpy, heat3d) through their entry
     points (matmul, gesummv_op, axpy_op, heat3d) at the paper's sizes and
     at sizes far past the 50 MB L2, fp32 and bf16: each output against its
     plain version at the stated tolerance, launch counts, CUDA-event times
     of kernel, plain version and library yardstick, and each bound; gemm's
     rows name the kernel that ran (the bf16 call at 8192^3 must be the
     wgmma one) and its wgmma launches; gemm and axpy are also timed over
     calls enqueued back to back (the device's time without the host's
     work between events); one more bf16 gemm at 8192 x 8190 x 8192, whose
     rows are not 16-byte strides, runs and is held on the mma kernel. Then
     heat3d also at H100 sizes whose rows are ragged, not 16-byte strides,
     or start one element into their buffer, each row naming the kernel
     instantiation it ran, with its device time and back-to-back time,
     and 50 steps at 512^3 run twice must agree bit for bit. Then
     mergesort (block_sort and the merge kernels) at n = 65536 and 2^26 in
     fp32, bf16 and int32, plus NaN cases: bit for bit against its plain
     version, as values against torch.sort, launch counts, times, bounds.
  6. training at full width: llama3.2-1b as get_config gives it (16
     layers, bf16, remat "full"), B 4 x 2048. (a) The flash kernel's
     output and log-sum-exp at that shape against the plain version (out
     bit for bit with and without lse), the forward's time with lse and
     without, and the autograd Function's dq, dk, dv with the kernel's
     forward against the plain forward's (one backward, plain PyTorch,
     timed); (b) one loss and backward on the kernel path and with the
     plain flash forward: the loss within 2e-3 (1e-4 on q/k-scaled
     weights, where attention is not chaotic), each leaf's gradient within
     5e-2 of its largest value, two flash launches a layer, beside two
     readings that place those limits: the plain path at half the KV chunk
     (sound) and the kernel path with its lse off by 0.1 (a planted fault,
     which must miss the gradient limit); then the bare step's ms
     (make_train_step outside the launcher), on one batch, and again with
     the data pipeline's prefetch thread drawing batches beside it, and the
     pipeline's time for one batch alone; (c) the train launcher (python
     -m repro_torch.launch.train) for 6 steps: every loss finite, ms a step
     (the launcher's own, the step alone) and its wall time a step (the
     wait for data included), tokens/s, peak GiB, flash launches a step,
     counted from 0 just before; (d) its restart recipe at smoke size on
     the card.
  7. serving on a mesh: four ranks over torch.distributed on a (4, 1)
     ("data", "model") DeviceMesh (NCCL, one rank a card, where there are
     four cards; else gloo, the four on cuda:0), llama3.2-1b at full width
     in bf16, one slot at 524288 tokens: the sequence-parallel layout,
     each rank a quarter of the pages, each decode merging the ranks'
     partials by their log-sum-exp, which the decode kernel writes. First
     the per-slot decode kernel's lse against the plain version at the
     phase's shapes (its fp32 output rounds to the one without it bit for
     bit), and the one-device engine at 262128 tokens serving three
     prompts (256-2048 tokens, 32 new each) in copy mode. Then each
     rank: (a) the same
     serve on the mesh: tokens bit for bit across ranks, first-token
     logits within 5e-2 of the one-device serve's, the equal-token count
     (a reading: the init is chaotic), ms a step, each rank's decode
     call's device time (one rank at a time), launches from 0; (b) decode
     on the mesh against prefill a layer at a time (layer_rel < 5e-2);
     (c) every layer's pools filled with seeded K/V to 524288 - 64 tokens,
     three forward_decode steps: each layer's output against one decode
     over the whole unsharded pool, within min(2e-2, 2e-2 x max|plain|),
     and each rank's pools bit for bit. A rank's failure fails the phase.
  8. training on a mesh: four ranks as in 7 on a (2, 2) ("data", "model")
     mesh, llama3.2-1b at full width in bf16 cut to 2 layers (wq, wk x
     0.1), B 4 x 2048 (2 x 2048 a data rank), each rank its blocks of
     every parameter and optimizer buffer (FSDP over data, TP over model).
     First the flash kernel at a rank's shape, q (2, 2048, 16, 64) over
     (2, 2048, 4, 64), with lse, against the plain version; the one-device
     steps on the same weights and batches, and a planted fault (the
     steps on one data rank's rows, what a missing reduce-scatter gives).
     Then each rank: the step's collectives timed alone; (a) three steps
     held against the one-device steps (loss 2e-3, gradient norm 2e-2,
     params and master 0.1 of the steps' own change), which the fault
     must miss; ms a step, peak GiB, flash launches, the embedding leaves'
     shapes as the loss used them (on (2, 2) each rank's vocab block:
     the table (64128, 2048), not (128256, 2048)); the same steps with
     each rank clamping the label into its vocab block instead of masking
     it, which must miss too; (b) the replicated blocks bit for bit
     across ranks; (c) a save on (2, 2), the restore on (4, 1) and on one
     device bit for bit, one more step on (4, 1) held alike, with its
     peak GiB and embedding shapes. A rank's failure fails the phase.
  9. MoE training on a mesh: four ranks as in 7, olmoe-1b-7b at full
     width in bf16 cut to 1 layer (wq, wk x 0.1), B 4 x 2048, the experts
     split over model (expert parallelism) and d over data. First flash
     at a (2, 2) rank's shape, q (2, 2048, 8, 128) over (2, 2048, 8, 128),
     with lse, against the plain version. Then each rank: one step on
     (4, 1), experts whole, the yardstick (every mesh of four routes in
     the same four token groups; one device routes in one, so its step is
     not one); one on (2, 2) and on (1, 4), 32 and 16 experts a rank,
     held against it (loss 2e-3, gradient norm 2e-2, params and master 0.1
     of the steps' own change, the routers' master 0.5), with the (token,
     choice) pairs of layer 0 routed otherwise, the dropped share, ms a
     step, peak GiB, flash launches and the embedding leaves' shapes as
     used (each rank's vocab block where it splits); a planted fault (the
     router's gradient not summed over model), which must miss, and a sound
     variant (the plain MoE FFN in the step), which must pass, on (1, 4);
     the replicated leaves bit for bit; the (2, 2) save restored on (1, 4)
     bit for bit; one moe_ffn call's device ms on a (2, 2) rank's experts
     and on a (4, 1) rank's; kimi-k2 at smoke size (a dense first layer, a
     shared expert) on (2, 2) against (4, 1). A rank's failure fails the
     phase.
 10. Recurrent training on a mesh: four ranks as in 7, each its blocks
     (rwkv6's heads, mamba's d_in and the MLP's d_ff over model, d over
     data). First flash at every rank shape of jamba's smoke steps (fp32
     D 16) against the plain version, with lse. Then the one-device steps
     of rwkv6-3b at full width in bf16 on 2 layers (B 4 x 2048) and of
     jamba's first layer at full width (mamba, d_in 16384, and its dense
     MLP; B 4 x 128), and on the ranks one step of rwkv6 on (2, 2),
     (1, 4) and (4, 1) and of jamba's layer on (4, 1), (2, 2) and (1,
     4), each held against them (phase 8's limits; jamba's gradient norm
     within twice its (4, 1) witness's reading, the mesh without tensor
     parallelism, where that is larger), with ms a step and peak GiB;
     a planted fault (in_proj's contiguous block taken as (xi, z)) on
     jamba's (1, 4), which must miss; the replicated leaves bit for bit;
     rwkv6's (2, 2) save restored on (1, 4) bit for bit; jamba at smoke
     size on its five-layer cut on (2, 2) and (1, 4) against (4, 1), each
     step's loss within 1e-5. A rank's failure fails the phase.
 11. Cross-attention training on a mesh: four ranks as in 7, each its
     blocks (the self- and cross-attention's heads, the encoder's, the
     MLPs' d_ff over model, d over data; the gates whole). First flash at
     every rank shape the phase gives it (seamless's causal self-, non-
     causal encoder and cross-attention over 3072 frames on each mesh;
     vision's cross-attention over 4096 image tokens, tensor-parallel and
     whole; vision's smoke steps, fp32 D 16) against the plain version,
     with lse. Then the one-device steps of seamless-m4t-medium at full
     width in bf16 on 2 encoder and 2 decoder layers (B 4 x 512 over 3072
     random frames, every gate 1.0), and on the ranks three steps on (2,
     2), (1, 4) and (4, 1), each held against them (phase 8's limits, the
     encoder's and the cross leaves' master 0.1 too); (1, 4) again with
     the encoder output entering the cross-attention without copy_to,
     which must miss on the encoder's leaves; the replicated leaves bit
     for bit; the (2, 2) save restored on (1, 4) bit for bit;
     llama-vision's xattn_mlp layer at full width (d 8192, 64/8 heads,
     d_ff 28672), its tensor-parallel form on (2, 2) and (1, 4) against
     the whole layer on each rank's rows: the output and the gradients of
     x, the image rows and every leaf, the gate's included; vision at
     smoke size on its five layers on (2, 2) and (1, 4) against (4, 1),
     each step's loss within 1e-5 and the state 1e-4; seamless's
     embedding leaves' shapes as used (its 256206 rows split over a model
     axis of 2, not 4). A rank's failure fails the phase.
 12. GPipe (launch/pipeline.py) over a (4,) ("stage",) mesh of four ranks
     as in 7. (a) The reference test's case (W (8, 16, 16), x (6, 2, 4,
     16), fp32) against the one-device stack: the output within 1e-5 and
     each stage's W gradient within 1e-4; (b) llama3.2-1b's 16 blocks at
     full width in fp32, 4 a stage, a batch of 8 x 512 in 4 microbatches:
     the output and each leaf's gradient within 1e-4 of its largest value
     against the one-device stack, ms a forward and backward beside the
     one-device stack's, flash launches a rank, peak GiB, the bubble
     fraction. A rank's failure fails the phase.
 13. The reference's serve steps on a mesh (launch/steps.py's
     make_prefill_step and make_decode_step with placed weights and
     cache): four ranks as in 7, llama3.2-1b at full width in bf16 (wq, wk
     x 0.1), each rank its blocks of the parameters (FSDP over data, TP
     over model) and of the per-slot cache (its rows, and its 64 / model
     tokens of every page of 64: 8 KV heads are fewer than 16), phase 3's
     eight prompts right-padded to 512, 1024 tokens a slot, 16 greedy
     decode steps (sample=True: the argmax over the vocab-parallel head
     by one all-reduce MAX and one MIN); on (1, 4) at full depth, on (2,
     2) and (4, 1) on phase 8's 2-layer cut. First flash (q (B / data,
     512, 32 / model, 64) over its 8 / model KV heads, causal) and the
     per-slot decode kernel (every q head over the rank's slice of the
     pages, with lse where the page splits) at every rank shape against
     their plain versions, timed; the one-device steps on the same
     weights (the ranks are fed its greedy tokens). Then each rank: its
     blocks' bytes equal to abstract's prediction, exactly; the prefill's
     logits and one later step's within 5e-2 of the one-device steps';
     the first greedy tokens equal wherever the one-device top-2 margin
     exceeds twice the logits' gap (the rest, and each step's tokens, a
     reading); model replicas bit for bit; ms a step beside one device's,
     peak GiB, each kernel's launches from 0 (flash one a layer, the
     per-slot decode one a layer a step). A rank's failure fails the
     phase.
With ``--profile``, phase 3 is served a second time under torch.profiler.
Then one JSON line of per-kernel numbers, and the contract line
``{"ok": true, "device": {...}}`` last.

    python3 chip_smoke.py --decode-only [--src DIR]

builds the decode kernel and runs phase 2's decode rows alone, then the
precision row, importing repro_torch from DIR (another tree's src/) if
given: two trees timed in turns, one process each (the cancellation case
comes from this script's own tree).

    python3 chip_smoke.py --train-only

builds the flash kernel and runs phase 6 alone.

    python3 chip_smoke.py --mesh-only

builds the decode and flash kernels and runs phase 7 alone.

    python3 chip_smoke.py --mesh-train-only

builds the flash kernel and runs phase 8 alone.

    python3 chip_smoke.py --mesh-moe-only

builds the flash kernel and runs phase 9 alone.

    python3 chip_smoke.py --mesh-recurrent-only

builds the flash kernel and runs phase 10 alone.

    python3 chip_smoke.py --mesh-cross-only

builds the flash kernel and runs phase 11 alone.

    python3 chip_smoke.py --kimi-only

builds the decode and flash kernels, runs phase 2's rows at head dim 112
(kimi-k2's decode row, the flash cases and the timed prefill) and phase 3i.

    python3 chip_smoke.py --pipeline-only

builds the flash kernel and runs phase 12 alone.

    python3 chip_smoke.py --mesh-serve-only

builds the decode and flash kernels and runs phase 13 alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # fp32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Flash is also held to this share of its plain output's largest value,
# where that is the tighter limit: a long non-causal softmax is nearly
# flat, so its outputs are small (about sqrt(e / Skv) for random inputs).
FLASH_REL_TOL = 2e-2
FLASH_KV_TILE = 64      # the wgmma kernel's KV rows a tile (kBKW)
SMOKE_POOL = 8          # phase 4's tight pool (tests/conformance.py's POOL)
# Decode/prefill shapes of the full-width serve below.
HQ, HKV, D, PAGE = 32, 8, 64, 16
DEC_B, DEC_P = 8, 64
FLASH_B, FLASH_S = 4, 512


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """CUDA-event time of ``iters`` calls enqueued back to back, over
    ``iters``: the host's work for one call overlaps the device's work for
    the one before, so for a call longer than that work this is the
    device's time alone."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# ------------------------------------------------------------------ phase 1

def phase_card(sources=None) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from repro_torch.kernels.build import SOURCES, build
    sources = SOURCES if sources is None else sources
    t0 = time.perf_counter()
    logs = build(sources, ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("phase1 card+build", card=card, sources=list(sources),
         build_s=round(seconds, 3), ptxas=ptxas)
    return {"card": card}


# ------------------------------------------------------------------ phase 2

def _decode_inputs(dtype, rng):
    """B=8 rows over one pool of B*P pages: lengths 0, 1, a partial page, a
    full table; shared pages; NULL entries; an inactive all-NULL row."""
    total = DEC_B * DEC_P
    null = total
    perm = rng.permutation(total)
    table = np.full((DEC_B, DEC_P), null, np.int32)
    lengths = np.array([0, 1, 23, DEC_P * PAGE, 500, 1, 700, 333], np.int32)
    nxt = 0

    def fresh(n):
        nonlocal nxt
        out = perm[nxt:nxt + n]
        nxt += n
        return out

    for b, ln in enumerate(lengths):
        if b == 5:
            continue                       # inactive slot: all NULL, len 1
        n = -(-int(ln) // PAGE)
        table[b, :n] = fresh(n)
    table[4, :20] = table[3, :20]          # shares the full row's prefix
    table[6, :31] = table[3, :31]          # shares a partial page too
    table[7, :5] = table[4, :5]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q = mk(DEC_B, HQ, D)
    kp = mk(total, PAGE, HKV, D)
    vp = mk(total, PAGE, HKV, D)
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths).cuda())


def _decode_bound(q, kp, table, lengths) -> tuple:
    """Bytes the decode must move (each valid K/V token once, even when two
    rows share its page; q in, out once) and its flops, for this data."""
    total, page, hkv, d = kp.shape
    tbl = table.cpu().numpy()
    lens = lengths.cpu().numpy()
    tokens = set()
    flops = 0
    for b in range(tbl.shape[0]):
        n = min(int(lens[b]), tbl.shape[1] * page)
        flops += 4 * q.shape[1] * n * d
        for pos in range(n):
            e = int(tbl[b, pos // page])
            if e < total:
                tokens.add((e, pos % page))
    it = kp.element_size()
    nbytes = (2 * len(tokens) * hkv * d * it + 2 * q.numel() * it
              + table.numel() * 4 + lengths.numel() * 4)
    return nbytes, flops


def _slot_decode_inputs(dtype, rng):
    """B=8 per-slot pools of P pages each, every table a random permutation;
    lengths 0, 1, a partial page and a full table among them."""
    table = np.stack([rng.permutation(DEC_P) for _ in range(DEC_B)]) \
        .astype(np.int32)
    lengths = np.array([0, 1, 23, DEC_P * PAGE, 500, 129, 700, 333], np.int32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q = mk(DEC_B, HQ, D)
    kp = mk(DEC_B, DEC_P, PAGE, HKV, D)
    vp = mk(DEC_B, DEC_P, PAGE, HKV, D)
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths).cuda())


def _slot_decode_bound(q, kp, table, lengths) -> tuple:
    """Bytes and flops of a per-slot decode for this data: each row's valid
    K/V tokens once (slots share no pages), q in, out once, the table."""
    _, n_pages, page, hkv, d = kp.shape
    n = np.minimum(lengths.cpu().numpy().astype(np.int64), n_pages * page)
    it = kp.element_size()
    nbytes = (2 * int(n.sum()) * hkv * d * it + 2 * q.numel() * it
              + table.numel() * 4 + lengths.numel() * 4)
    return nbytes, 4 * q.shape[1] * d * int(n.sum())


def _sdpa_gathered(q, k, v, lens):
    """The library yardstick: SDPA over logical (B, P, page, Hkv, D) K/V
    gathered and repeated to Hq beforehand (the gather, the paged part, is
    not timed)."""
    B, Hq, Dh = q.shape
    Hkv = k.shape[-2]
    G = Hq // Hkv
    kd = k.reshape(B, -1, Hkv, Dh).repeat_interleave(G, 2).transpose(1, 2) \
        .contiguous()
    vd = v.reshape(B, -1, Hkv, Dh).repeat_interleave(G, 2).transpose(1, 2) \
        .contiguous()
    pos = torch.arange(kd.shape[2], device="cuda")
    mask = (pos[None] < lens[:, None])[:, None, None, :]
    qd = q[:, :, None, :]
    ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    del kd, vd
    torch.cuda.empty_cache()
    return ms


def _bound(nbytes, flops, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_flops(B, Sq, Skv, Hq, D, causal, window, q_offset):
    qp = np.arange(Sq)[:, None] + q_offset
    kp = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    return 4 * B * Hq * D * int(mask.sum())


# Long-context decode past the 50 MB L2, bf16, every row full: (layout, B,
# Hq, Hkv, D, tokens a row). llama3.2-1b's widths and qwen2-7b's (G = 7)
# over one shared pool of 8192 pages, then llama3.2-1b's over per-slot
# pools; 268,435,456 K/V bytes each.
DECODE_LONG = [("global", 32, 32, 8, 64, 4096),
               ("global", 16, 28, 4, 128, 8192),
               ("slot", 32, 32, 8, 64, 4096)]
# The decode kernels at phases 3e-3h's serving shapes, bf16: (arch, layout, B,
# Hq, Hkv, D, pages a row, softcap, lowest and highest length). Global: a
# pool of B x pages-a-row pages behind random tables, NULL past each row's
# length, as the serve's tables are. Per-slot: gemma2's rings of 256 pages,
# random tables, every length past their 4096 tokens (the kernel clamps it
# to the capacity).
DECODE_ARCHS = [("qwen2-7b", "global", 8, 28, 4, 128, 64, None, 185, 513),
                ("llama3.2-3b", "global", 8, 24, 8, 128, 64, None, 185, 513),
                ("gemma2-2b", "global", 4, 8, 4, 256, 512, 50.0, 4500, 6032),
                ("gemma2-2b", "slot", 4, 8, 4, 256, 256, 50.0, 4500, 6032),
                # phase 3f's: MHA, two head groups of 8; global and the
                # per-slot pools of its copy serve
                ("olmoe-1b-7b", "global", 8, 16, 16, 128, 64, None, 185, 513),
                ("olmoe-1b-7b", "slot", 8, 16, 16, 128, 64, None, 185, 513),
                # phase 3g's jamba attention layer: G = 8, D 128; global,
                # and the per-slot pools of its copy serve
                ("jamba-1.5-large-398b", "global", 8, 64, 8, 128, 64, None,
                 100, 543),
                ("jamba-1.5-large-398b", "slot", 8, 64, 8, 128, 64, None,
                 100, 543),
                # phase 3h's seamless decoder: MHA 16/16, D 64; global and
                # per-slot (llama-vision's self-attention has jamba's
                # shape, held above)
                ("seamless-m4t-medium", "global", 8, 16, 16, 64, 64, None,
                 185, 513),
                ("seamless-m4t-medium", "slot", 8, 16, 16, 64, 64, None,
                 185, 513),
                # phase 3i's kimi-k2: G = 8 at D 112 (224-byte rows)
                ("kimi-k2-1t-a32b", "global", 8, 64, 8, 112, 64, None, 185,
                 513)]
DECODE_KERNELS = "paged_decode"       # every decode kernel's name holds it


def _call_device(fn, name: str = DECODE_KERNELS, iters: int = 20) -> tuple:
    """(device ms a call of the kernels whose name holds ``name``, device
    launches a call of any kernel, launches recorded) over ``iters`` calls
    of ``fn``, from torch.profiler: the kernels alone, without the
    wrapper's host work between them. A session that records fewer than
    one of them a call (it loses events now and then in a long process,
    and the sum over fewer launches than calls is no call's time) is tried
    again, up to three times; then (None, None, recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    recorded = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        mine = [e for e in evs if name in e.key]
        recorded = sum(e.count for e in mine)
        if recorded >= iters:
            dev = sum(_device_us(e) for e in mine) / iters / 1e3
            return dev, sum(e.count for e in evs) / iters, recorded
    return None, None, recorded


def _decode_times(call, plain, nbytes, flops, dtype, plain_iters=5) -> dict:
    """One call's CUDA-event ms, its device ms and launches, the time of
    calls enqueued back to back, the plain version's ms and the bound."""
    dev, per_call, recorded = _call_device(call)
    bound, by = _bound(nbytes, flops, dtype)
    ms = cuda_ms(call)
    return dict(ms=ms, device_ms=dev, ms_back_to_back=back_to_back_ms(call),
                kernel_launches_per_call=per_call,
                device_launches_recorded=recorded,
                plain_ms=cuda_ms(plain, warmup=1, iters=plain_iters),
                bound_ms=bound, bound_by=by, bound_share=bound / ms,
                device_bound_share=None if dev is None else bound / dev,
                bytes=nbytes, flops=flops)


def _long_decode_inputs(layout, B, Hq, Hkv, Dh, tokens, g):
    n = tokens // PAGE
    mk = lambda *sh: torch.randn(*sh, generator=g, device="cuda",
                                 dtype=torch.bfloat16)
    if layout == "global":
        table = torch.randperm(B * n, generator=g, device="cuda") \
            .to(torch.int32).view(B, n)
        shape = (B * n, PAGE, Hkv, Dh)
    else:
        table = torch.stack([torch.randperm(n, generator=g, device="cuda")
                             for _ in range(B)]).to(torch.int32)
        shape = (B, n, PAGE, Hkv, Dh)
    lens = torch.full((B,), tokens, dtype=torch.int32, device="cuda")
    return mk(B, Hq, Dh), mk(*shape), mk(*shape), table, lens


def _decode_long() -> list:
    """Both decode kernels at the DECODE_LONG shapes: error against the
    plain version (exact zeros are not at stake: every row is full), times
    beside the byte bound, and SDPA on the gathered K/V."""
    from repro_torch.kernels import paged_attention_global
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import (
        gather_global_pages, gather_slot_pages, paged_attention_global_ref,
        paged_attention_ref)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for layout, B, Hq, Hkv, Dh, tokens in DECODE_LONG:
        q, kp, vp, tbl, lens = _long_decode_inputs(layout, B, Hq, Hkv, Dh,
                                                   tokens, g)
        fn, ref_fn, gather, bound_fn = (
            (paged_attention_global, paged_attention_global_ref,
             gather_global_pages, _decode_bound) if layout == "global" else
            (paged_attention, paged_attention_ref, gather_slot_pages,
             _slot_decode_bound))
        out = fn(q, kp, vp, tbl, lens)
        ref = ref_fn(q, kp, vp, tbl, lens)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        del ref
        assert torch.isfinite(out).all(), f"long decode {layout}: non-finite"
        assert err <= TOL[torch.bfloat16], f"long decode {layout}: err {err}"
        nbytes, flops = bound_fn(q, kp, tbl, lens)
        row = dict(layout=layout, dtype=str(torch.bfloat16), B=B, Hq=Hq,
                   Hkv=Hkv, D=Dh, page=PAGE, tokens=tokens, max_abs_err=err,
                   tol=TOL[torch.bfloat16],
                   **_decode_times(lambda: fn(q, kp, vp, tbl, lens),
                                   lambda: ref_fn(q, kp, vp, tbl, lens),
                                   nbytes, flops, torch.bfloat16,
                                   plain_iters=3))
        row["sdpa_gathered_ms"] = _sdpa_gathered(q, gather(kp, tbl),
                                                 gather(vp, tbl), lens)
        emit("phase2 decode long", **row)
        rows.append(row)
        del q, kp, vp, out
        torch.cuda.empty_cache()
    return rows


def _arch_decode_inputs(layout, B, Hq, Hkv, Dh, pages, lo, hi, g):
    mk = lambda *sh: torch.randn(*sh, generator=g, device="cuda",
                                 dtype=torch.bfloat16)
    lens = torch.randint(lo, hi + 1, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    if layout == "global":
        total = B * pages
        table = torch.randperm(total, generator=g, device="cuda") \
            .to(torch.int32).view(B, pages)
        used = (lens + PAGE - 1) // PAGE
        table[torch.arange(pages, device="cuda")[None] >= used[:, None]] = \
            total                                       # NULL
        shape = (total, PAGE, Hkv, Dh)
    else:
        table = torch.stack([torch.randperm(pages, generator=g, device="cuda")
                             for _ in range(B)]).to(torch.int32)
        shape = (B, pages, PAGE, Hkv, Dh)
    return mk(B, Hq, Dh), mk(*shape), mk(*shape), table, lens


def _decode_archs(arch_only=None) -> list:
    """Both decode kernels at the DECODE_ARCHS shapes (with ``arch_only``,
    that arch's alone): error against the plain version on the same
    inputs, times beside the bound."""
    from repro_torch.kernels import paged_attention_global
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_global_ref, paged_attention_ref)
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rows = []
    for arch, layout, B, Hq, Hkv, Dh, pages, cap, lo, hi in DECODE_ARCHS:
        if arch_only is not None and arch != arch_only:
            continue
        q, kp, vp, tbl, lens = _arch_decode_inputs(layout, B, Hq, Hkv, Dh,
                                                   pages, lo, hi, g)
        fn, ref_fn, bound_fn = (
            (paged_attention_global, paged_attention_global_ref,
             _decode_bound) if layout == "global" else
            (paged_attention, paged_attention_ref, _slot_decode_bound))
        out = fn(q, kp, vp, tbl, lens, softcap=cap)
        ref = ref_fn(q, kp, vp, tbl, lens, softcap=cap)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert torch.isfinite(out).all(), f"decode {arch} {layout}: non-finite"
        assert err <= TOL[torch.bfloat16], \
            f"decode {arch} {layout}: err {err}"
        nbytes, flops = bound_fn(q, kp, tbl, lens)
        capacity = pages * PAGE
        row = dict(arch=arch, layout=layout, dtype=str(torch.bfloat16), B=B,
                   Hq=Hq, Hkv=Hkv, D=Dh, page=PAGE, pages_a_row=pages,
                   softcap=cap, lengths=lens.tolist(), capacity=capacity,
                   past_capacity=int((lens > capacity).sum()),
                   max_abs_err=err, tol=TOL[torch.bfloat16],
                   **_decode_times(
                       lambda: fn(q, kp, vp, tbl, lens, softcap=cap),
                       lambda: ref_fn(q, kp, vp, tbl, lens, softcap=cap),
                       nbytes, flops, torch.bfloat16, plain_iters=3))
        emit("phase2 decode arch", **row)
        rows.append(row)
        del q, kp, vp, out, ref
        torch.cuda.empty_cache()
    return rows


def phase_decode() -> dict:
    """Phase 2's decode rows: both layouts at the serving shapes (fp32 and
    bf16, softcap None and 30, exact zeros in the length-0 and all-NULL
    rows), their times, the "hbm" residency turns, then DECODE_LONG. The
    serving shapes' K/V fit in the L2: their times are L2-warm."""
    from repro_torch.kernels import paged_attention_global
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import (
        gather_global_pages, gather_slot_pages, paged_attention_global_ref,
        paged_attention_ref)
    rng = np.random.default_rng(SEED)
    res = {}
    # ---- paged decode
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tbl, lens = _decode_inputs(dtype, rng)
        errs = []
        for cap in (None, 30.0):
            out = paged_attention_global(q, kp, vp, tbl, lens, softcap=cap)
            ref = paged_attention_global_ref(q, kp, vp, tbl, lens, softcap=cap)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            errs.append(err)
            assert torch.isfinite(out).all(), "decode kernel: non-finite"
            assert (out[0] == 0).all(), "decode kernel: length-0 row != 0"
            assert (out[5] == 0).all(), "decode kernel: all-NULL row != 0"
            assert err <= TOL[dtype], f"decode {dtype} cap={cap}: err {err}"
            emit("phase2 decode", dtype=str(dtype), softcap=cap,
                 max_abs_err=err, tol=TOL[dtype])
        nbytes, flops = _decode_bound(q, kp, tbl, lens)
        t = _decode_times(
            lambda: paged_attention_global(q, kp, vp, tbl, lens),
            lambda: paged_attention_global_ref(q, kp, vp, tbl, lens),
            nbytes, flops, dtype)
        sdpa = _sdpa_gathered(q, gather_global_pages(kp, tbl),
                              gather_global_pages(vp, tbl), lens)
        emit("phase2 decode timing", dtype=str(dtype), l2_warm=True,
             sdpa_gathered_ms=sdpa, **t)
        res[("decode", dtype)] = dict(err=max(errs), sdpa=sdpa, **t)
        # The LLC-off baseline: pages gathered through the table first, then
        # the per-slot kernel on an identity table. In turns with "smem".
        out = paged_attention_global(q, kp, vp, tbl, lens,
                                     table_residency="hbm")
        ref = paged_attention_global_ref(q, kp, vp, tbl, lens)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype], f"decode hbm {dtype}: err {err}"
        turns = {"smem": [], "hbm": []}
        for mode in ("smem", "hbm", "hbm", "smem"):
            turns[mode].append(cuda_ms(lambda: paged_attention_global(
                q, kp, vp, tbl, lens, table_residency=mode)))
        emit("phase2 decode residency", dtype=str(dtype), max_abs_err_hbm=err,
             smem_ms=turns["smem"], hbm_ms=turns["hbm"])
        res[("residency", dtype)] = {m: statistics.mean(t)
                                     for m, t in turns.items()}
    # ---- per-slot paged decode (the copy baseline's layout)
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tbl, lens = _slot_decode_inputs(dtype, rng)
        errs = []
        for cap in (None, 30.0):
            out = paged_attention(q, kp, vp, tbl, lens, softcap=cap)
            ref = paged_attention_ref(q, kp, vp, tbl, lens, softcap=cap)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            errs.append(err)
            assert torch.isfinite(out).all(), "slot decode kernel: non-finite"
            assert (out[0] == 0).all(), "slot decode kernel: length-0 row != 0"
            assert err <= TOL[dtype], f"slot decode {dtype} cap={cap}: err {err}"
            emit("phase2 slot decode", dtype=str(dtype), softcap=cap,
                 max_abs_err=err, tol=TOL[dtype])
        nbytes, flops = _slot_decode_bound(q, kp, tbl, lens)
        t = _decode_times(lambda: paged_attention(q, kp, vp, tbl, lens),
                          lambda: paged_attention_ref(q, kp, vp, tbl, lens),
                          nbytes, flops, dtype)
        sdpa = _sdpa_gathered(q, gather_slot_pages(kp, tbl),
                              gather_slot_pages(vp, tbl), lens)
        emit("phase2 slot decode timing", dtype=str(dtype), l2_warm=True,
             sdpa_gathered_ms=sdpa, **t)
        res[("slot", dtype)] = dict(err=max(errs), sdpa=sdpa, **t)
    res["decode_long"] = _decode_long()
    res["decode_archs"] = _decode_archs()
    return res


def _precision_module():
    """repro_torch/kernels/paged_attention/precision.py of this script's
    tree, loaded by path: with --src another tree's kernel is measured on
    the same case."""
    import importlib.util
    path = os.path.join(HERE, "src", "repro_torch", "kernels",
                        "paged_attention", "precision.py")
    spec = importlib.util.spec_from_file_location("_decode_precision", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode_precision() -> dict:
    """bf16 decode's precision in P, both layouts, on the cancellation case:
    the kernel's max error against the fp32 plain version, beside that of
    a plain decode that rounds P to bf16 (l from the unrounded P). The
    case must bite (the rounded decode misses by more than 16 times the
    output's own bf16 rounding) and the kernel must stay within 1/16 of
    the rounded decode's error."""
    from repro_torch.kernels import paged_attention_global
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_global_ref, paged_attention_ref)
    prec = _precision_module()
    res = {}
    for per_slot in (False, True):
        args = prec.p_cancellation_case(per_slot, "cuda")
        fn, ref_fn = ((paged_attention, paged_attention_ref) if per_slot
                      else (paged_attention_global,
                            paged_attention_global_ref))
        out = fn(*args)
        q, kp, vp, tbl, lens = args
        ref32 = ref_fn(q.float(), kp.float(), vp.float(), tbl, lens)
        rounded = prec.decode_p_rounded(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref32).abs().max().item()
        err_rounded = (rounded - ref32).abs().max().item()
        row = dict(layout="slot" if per_slot else "global",
                   dtype=str(torch.bfloat16), shape=list(q.shape),
                   tokens=int(lens[0]), max_abs_err=err,
                   max_abs_err_p_rounded=err_rounded,
                   ratio=err_rounded / max(err, 1e-30),
                   output_max=ref32.abs().max().item(),
                   # half a bf16 spacing at the largest output, at most
                   output_rounding=ref32.abs().max().item() * 2.0 ** -8)
        emit("phase2 decode precision", **row)
        res[row["layout"]] = row
    for layout, row in res.items():
        assert row["max_abs_err_p_rounded"] > 16 * row["output_rounding"], \
            f"decode precision {layout}: the case does not bite {row}"
        assert row["max_abs_err"] <= row["max_abs_err_p_rounded"] / 16, \
            f"decode precision {layout}: P lost precision {row}"
    return res


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32 here
    torch.backends.cudnn.allow_tf32 = False
    res = phase_decode()
    res["precision"] = _decode_precision()
    res["flash_cases"] = _flash_cases()
    res["flash_timed"] = _flash_timed()
    res["moe"] = _moe_rows()
    return res


# Flash prefill. Small mask cases in fp32 and bf16 (head dims 16 and 32 on
# the CUDA-core kernel, 64 in fp32 too; bf16 at 64 on the wgmma kernel),
# then bf16 only at the wgmma kernel's head dims 128 and 256.
FLASH_CASES = [(2, 100, 100, 8, 2, 64, True, None, 30.0, 0),
               (2, 128, 128, 8, 2, 64, True, 48, None, 0),
               (2, 100, 164, 8, 2, 64, True, None, None, 64),
               (2, 96, 96, 4, 4, 64, False, None, None, 0),
               (2, 80, 80, 4, 2, 16, True, 24, 20.0, 0),
               (1, 70, 90, 4, 1, 32, True, None, None, 20),
               # fewer query rows than a tile: cross-attention's decode
               # (Sq = 1, non-causal) over sources shorter and longer than
               # a KV tile (phase 4's smoke: 16 or 8 keys at D 16), and a
               # few causal rows with an offset
               (4, 1, 16, 4, 4, 16, False, None, None, 0),
               (4, 1, 8, 4, 2, 16, False, None, None, 0),
               (3, 1, 200, 8, 2, 64, False, None, None, 0),
               (2, 5, 100, 4, 2, 64, False, None, None, 0),
               (1, 33, 70, 4, 2, 32, True, None, None, 37)]
FLASH_WIDE_CASES = [(2, 100, 164, 8, 2, 128, True, 48, 50.0, 64),
                    (1, 130, 130, 4, 4, 128, False, None, None, 0),
                    (2, 77, 141, 4, 2, 256, True, 48, 50.0, 64),
                    (1, 200, 260, 8, 4, 256, True, None, 50.0, 60),
                    # phase 3e's prefills: llama3.2-3b's bucket of 512,
                    # gemma2's local layers at its bucket of 8192
                    (8, 512, 512, 24, 8, 128, True, None, None, 0),
                    (1, 8192, 8192, 8, 4, 256, True, 4096, 50.0, 0),
                    # Sq < 64 on the wgmma kernel at D 128 and 256: the
                    # 128-row TMA box of q reads zeros past Sq
                    (2, 1, 77, 8, 1, 128, False, None, None, 0),
                    (2, 5, 100, 4, 2, 256, False, None, None, 0),
                    (1, 17, 9, 4, 4, 128, False, None, None, 0),
                    # head dim 112 (kimi-k2's; the second slab padded):
                    # causal at G = 8, non-causal, Sq = 1, a window, a
                    # q_offset with a softcap
                    (2, 100, 100, 16, 2, 112, True, None, None, 0),
                    (1, 130, 130, 4, 4, 112, False, None, None, 0),
                    (2, 1, 77, 8, 1, 112, False, None, None, 0),
                    (1, 200, 260, 8, 1, 112, True, 100, None, 60),
                    (1, 65, 200, 8, 2, 112, True, None, 50.0, 150)]
# (bf16 also runs phase 3g's jamba prefills, _jamba_prefill_cases, phase
# 3h's, _cross_prefill_cases, and phase 3i's, _kimi_prefill_cases)
# Timed shapes (B, Sq, Skv, Hq, Hkv, D, causal): the serve's prefill, then
# llama3.2-1b's, qwen2-7b's and gemma2-2b's widths at 4096 tokens (gemma2
# without its softcap: SDPA has none), then olmoe-1b-7b's prefill of phase
# 3f (8 x 512, 16/16, D 128) and jamba's of phase 3g (8 x 512, 64/8, D
# 128); then phase 3h's non-causal shapes: seamless's encoder (8 x 3072,
# 16/16, D 64), its cross prefill (8 x 512 over 3072) and its cross decode
# (Sq 1 over 3072), llama-vision's cross prefill (8 x 512 over 4096 image
# tokens, 64/8, D 128) and its cross decode (Sq 1 over 4096); then kimi-k2's
# prefill of phase 3i (8 x 512, 64/8, D 112). bf16; the first also in fp32.
FLASH_TIMED = [(FLASH_B, FLASH_S, FLASH_S, HQ, HKV, D, True),
               (1, 4096, 4096, 32, 8, 64, True),
               (1, 4096, 4096, 28, 4, 128, True),
               (1, 4096, 4096, 8, 4, 256, True),
               (8, 512, 512, 16, 16, 128, True),
               (8, 512, 512, 64, 8, 128, True),
               (8, 3072, 3072, 16, 16, 64, False),
               (8, 512, 3072, 16, 16, 64, False),
               (8, 1, 3072, 16, 16, 64, False),
               (8, 512, 4096, 64, 8, 128, False),
               (8, 1, 4096, 64, 8, 128, False),
               (8, 512, 512, 64, 8, 112, True)]


def _flash_inputs(g, dtype, B, Sq, Skv, Hq, Hkv, Dh):
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    return mk(B, Sq, Hq, Dh), mk(B, Skv, Hkv, Dh), mk(B, Skv, Hkv, Dh)


def _flash_check(q, k, v, kw) -> dict:
    """Kernel against its plain version: the max abs error, and the limit
    it is held to, the smaller of TOL[dtype] and FLASH_REL_TOL of the plain
    output's largest value. Where a non-causal call spans more than one KV
    tile, the plain version with its first tile of keys dropped must miss
    that limit (``drop_err``): the limit would catch a kernel that skipped
    a tile."""
    from repro_torch.kernels import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import kernel_for
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    wgmma = flash_attention_fwd.wgmma_launches
    out = flash_attention_fwd(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = min(TOL[q.dtype], FLASH_REL_TOL * ref_max)
    want = kernel_for(q.dtype, q.shape[-1]) == "wgmma"
    assert flash_attention_fwd.wgmma_launches == wgmma + want, "wgmma count"
    assert torch.isfinite(out).all(), "flash kernel: non-finite"
    where = f"flash {q.dtype} {kw} {tuple(q.shape)} over {k.shape[1]}"
    assert err <= tol, f"{where}: err {err} > {tol}"
    row = dict(max_abs_err=err, tol=tol, ref_max=ref_max)
    if not kw["causal"] and k.shape[1] > FLASH_KV_TILE:
        drop = flash_attention_ref(q, k[:, FLASH_KV_TILE:],
                                   v[:, FLASH_KV_TILE:], **kw)
        row["drop_err"] = (drop.float() - ref.float()).abs().max().item()
        assert row["drop_err"] > tol, f"{where}: a dropped tile passes {row}"
    return row


def _jamba_prefill_cases() -> list:
    """Phase 3g's jamba prefills as flash takes them (causal, no window,
    exact lengths, none a tile multiple): each exact-length group of the
    zero-copy serve (B its rows, padded to a power of two as the engine
    pads) and each length at B 1 (copy mode, and the first-token check)."""
    cfg = _recurrent_cfg("jamba-1.5-large-398b")
    lens = [len(p) for p in _recurrent_requests(
        cfg, np.random.default_rng(SEED))]
    shapes = set()
    for L in lens:
        shapes |= {(1, L), (1 << (lens.count(L) - 1).bit_length(), L)}
    return [(B, L, L, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, True, None,
             None, 0) for B, L in sorted(shapes)]


def _cross_prefill_cases() -> list:
    """Phase 3h's prefills as flash takes them, for each arch at its
    width over its source (``_src_len``): the zero-copy serve's one call,
    its 8 requests padded to the engine's bucket (self-attention causal,
    cross-attention over the source); each request's exact length at B 1
    (copy mode, and the first-token check), both alike; and seamless's
    encoder over the source at B 8 and B 1, non-causal."""
    cases = set()
    for arch in CROSS_ATTN_ARCHS:
        cfg = _cross_arch_cfg(arch)
        src = _src_len(cfg)
        lens = [len(p) for p in requests(cfg.vocab_size,
                                         np.random.default_rng(SEED))]
        bucket = PAGE       # the engine's _bucket_len at max_len 1024
        while bucket < max(lens):
            bucket *= 2
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
        shapes = {(len(lens), bucket, bucket, True),
                  (len(lens), bucket, src, False)}
        for L in lens:
            shapes |= {(1, L, L, True), (1, L, src, False)}
        if cfg.is_encdec:
            shapes |= {(len(lens), src, src, False), (1, src, src, False)}
        cases |= {(B, Sq, Skv, *heads, causal, None,
                   cfg.attn_softcap if causal else None, 0)
                  for B, Sq, Skv, causal in shapes}
    return sorted(cases, key=lambda c: c[:7])


def _flash_cases(head_dim=None) -> list:
    """Every FLASH_CASES row in fp32 and bf16, and the wide rows in bf16,
    each held against the plain version; with ``head_dim`` only the rows of
    that head dim."""
    from repro_torch.kernels.flash_attention.ops import kernel_for
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    wide = (FLASH_WIDE_CASES + _jamba_prefill_cases() + _cross_prefill_cases()
            + _kimi_prefill_cases())
    for dtype in (torch.float32, torch.bfloat16):
        for (B, Sq, Skv, Hq, Hkv, Dh, causal, window, cap, qoff) in (
                FLASH_CASES + (wide if dtype == torch.bfloat16 else [])):
            if head_dim is not None and Dh != head_dim:
                continue
            q, k, v = _flash_inputs(g, dtype, B, Sq, Skv, Hq, Hkv, Dh)
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
            row = dict(dtype=str(dtype), B=B, Sq=Sq, Skv=Skv, Hq=Hq, Hkv=Hkv,
                       D=Dh, kernel=kernel_for(dtype, Dh),
                       **_flash_check(q, k, v, kw), **kw)
            emit("phase2 flash", **row)
            rows.append(row)
    return rows


def _kernel_device_ms(fn, name: str, iters: int = 20):
    """(mean device ms, launches recorded, their kernels' names) of the
    kernels whose name holds ``name`` over ``iters`` calls of ``fn``, from
    torch.profiler: the kernel alone, without the wrapper's host work. The
    profiler can record fewer launches than there were calls; the mean is
    over those it recorded. A session that records none is tried again, up
    to three times; then (None, 0, [])."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if name in e.key]
        count = sum(e.count for e in evs)
        if count:
            return (sum(_device_us(e) for e in evs) / count / 1e3, count,
                    sorted({e.key for e in evs}))
    return None, 0, []


def _flash_timed(head_dim=None) -> list:
    """CUDA-event ms of one call, the kernel's device ms, the plain
    version's and SDPA's (K/V repeated to Hq beforehand) ms, and the bound,
    at each timed shape: one row each, the serve's shape first (fp32, then
    bf16); with ``head_dim`` only the shapes of that head dim."""
    from repro_torch.kernels import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import kernel_for
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for i, (B, Sq, Skv, Hq, Hkv, Dh, causal) in enumerate(FLASH_TIMED):
        if head_dim is not None and Dh != head_dim:
            continue
        for dtype in ((torch.float32, torch.bfloat16) if i == 0
                      else (torch.bfloat16,)):
            q, k, v = _flash_inputs(g, dtype, B, Sq, Skv, Hq, Hkv, Dh)
            kw = dict(causal=causal, window=None, softcap=None, q_offset=0)
            check = _flash_check(q, k, v, kw)
            kind = kernel_for(dtype, Dh)
            call = lambda: flash_attention_fwd(q, k, v, **kw)
            ms = cuda_ms(call)
            dev, dev_n, _ = _kernel_device_ms(
                call, "flash_fwd_wgmma_kernel" if kind == "wgmma"
                else "flash_fwd_kernel<")
            plain = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw),
                            warmup=1, iters=5 if i == 0 else 3)
            G = Hq // Hkv
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
            vt = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
            sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            del qt, kt, vt
            flops = _flash_flops(B, Sq, Skv, Hq, Dh, causal, None, 0)
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            bound, by = _bound(nbytes, flops, dtype)
            row = dict(dtype=str(dtype), B=B, Sq=Sq, Skv=Skv, Hq=Hq, Hkv=Hkv,
                       D=Dh, causal=causal, kernel=kind, **check, ms=ms,
                       device_ms=dev, device_launches_recorded=dev_n,
                       plain_ms=plain, library_ms=sdpa,
                       bound_ms=bound, bound_by=by,
                       bound_share=bound / ms,
                       device_bound_share=None if dev is None else bound / dev,
                       flops=flops, bytes=nbytes)
            emit("phase2 flash timing", **row)
            rows.append(row)
    return rows


# The MoE FFN at olmoe-1b-7b's full width, bf16: (name, B, S, lowest real
# length). A decode batch of 8 tokens (C = 2) and the serve's prefill
# bucket of 8 x 512, right-padded past each row's length (C = 640).
MOE_ARCH = "olmoe-1b-7b"
MOE_BATCHES = (("decode", 8, 1, 1), ("prefill", 8, 512, 185))


def _moe_bound(cfg, p, x, keep, experts) -> dict:
    """Bytes and operations this run's routing needs: the weights of the
    experts that hold a kept choice (3 d x d_ff matrices each), the router,
    x read and the output written; the three expert products of every kept
    choice and the router's product."""
    m = cfg.moe
    d, f, T = cfg.d_model, m.d_ff, keep.shape[0]
    touched = int(torch.unique(experts[keep]).numel())
    kept = int(keep.sum())
    per_expert = 3 * d * f * p["w_gate"].element_size()
    nbytes = (touched * per_expert + p["router"].numel()
              * p["router"].element_size() + 2 * T * d * x.element_size())
    flops = 2 * kept * d * f * 3 + 2 * T * d * m.n_experts
    bound, by = _bound(nbytes, flops, x.dtype)
    return dict(kept_pairs=kept, experts_touched=touched,
                weights_bytes_every_expert=m.n_experts * per_expert,
                bytes=nbytes, flops=flops, bound_ms=bound, bound_by=by)


def _moe_rows() -> list:
    """moe_ffn (index dispatch, the main path) against moe_ffn_ref (the
    reference's one-hot einsums) on one layer's MoE weights at olmoe's full
    width, for each of MOE_BATCHES: keep masks bit for bit, the max error,
    one call under the sync debug mode "error", CUDA-event times of both
    and the bound. Padding positions hold one vector, as token 0's do, and
    route like any token."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import (capacity, moe_ffn, moe_ffn_ref,
                                        moe_specs, route)
    from repro_torch.models.params import materialize
    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    p = materialize(moe_specs(cfg, (2.0 * cfg.n_layers) ** -0.5), cfg, g,
                    "cuda")
    rows = []
    for name, B, S, lo in MOE_BATCHES:
        x = torch.randn(B, S, cfg.d_model, generator=g, device="cuda").to(
            torch.bfloat16)
        lens = torch.randint(lo, S + 1, (B,), generator=g, device="cuda")
        pad = torch.arange(S, device="cuda")[None] >= lens[:, None]
        x = torch.where(pad[..., None], x[:1, :1], x)
        out, keep = moe_ffn(p, x, cfg, return_keep=True)
        ref, ref_keep = moe_ffn_ref(p, x, cfg, return_keep=True)
        torch.cuda.synchronize()
        keep_equal = torch.equal(keep, ref_keep)
        err = (out.float() - ref.float()).abs().max().item()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe_ffn(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        experts, _ = route(p, x.reshape(B * S, -1), cfg)
        T = B * S
        row = dict(arch=MOE_ARCH, batch=name, dtype=str(torch.bfloat16), B=B,
                   S=S, tokens=T, real_tokens=int(lens.sum()),
                   experts=m.n_experts, top_k=m.experts_per_token,
                   d_model=cfg.d_model, d_ff=m.d_ff,
                   capacity_factor=m.capacity_factor,
                   capacity=capacity(T, m), pairs=T * m.experts_per_token,
                   keep_equal=keep_equal, max_abs_err=err,
                   tol=TOL[torch.bfloat16], no_host_sync=True,
                   **_moe_bound(cfg, p, x, keep, experts))
        row["dropped_share"] = 1 - row["kept_pairs"] / row["pairs"]
        row["ms"] = cuda_ms(lambda: moe_ffn(p, x, cfg))
        row["plain_ms"] = cuda_ms(lambda: moe_ffn_ref(p, x, cfg), warmup=1,
                                  iters=5)
        row["library_ms"] = None
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit("phase2 moe", **row)
        assert keep_equal, f"moe {name}: keep masks differ"
        assert torch.isfinite(out).all(), f"moe {name}: non-finite"
        assert err <= TOL[torch.bfloat16], f"moe {name}: err {err}"
        rows.append(row)
        del x, out, ref
    del p
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 3

def requests(vocab: int, rng, n: int = 8, system_len: int = 256,
             lo: int = 100, hi: int = 500):
    """n prompts of lo..hi tokens: half start with one shared system prompt
    of ``system_len`` tokens, and the second repeats the first exactly (it
    is admitted beside it, maps all its pages, and its first decode append
    lands in a shared page: a CoW copy)."""
    system = rng.integers(0, vocab, size=system_len).tolist()
    prompts = []
    for i in range(n - 1):
        if i % 2 == 0:
            # odd suffix: the prompt ends inside a page, so the repeat's
            # first append lands in a page the two share
            suffix = int(rng.integers(lo // 5, hi - system_len)) | 1
            prompts.append(system + rng.integers(0, vocab, size=suffix).tolist())
        else:
            prompts.append(rng.integers(0, vocab,
                                        size=int(rng.integers(lo, hi))).tolist())
    return prompts[:1] + [list(prompts[0])] + prompts[1:]


def serve(cfg, params, device, prompts, max_tokens, n_slots, max_len, page,
          kind="fixed", **engine_kw):
    """Serve ``prompts`` on a fresh engine of ``kind`` (the scheduler:
    fixed or continuous; or disagg-share / disagg-copy, the slots split
    evenly between the prefill and the decode worker), zero-copy unless
    ``engine_kw`` says otherwise; returns (outputs, engine, finished, wall
    seconds)."""
    from repro_torch.core.serving.disagg import DisaggEngine
    from repro_torch.core.serving.engine import ServingEngine
    if kind.startswith("disagg-"):
        eng = DisaggEngine(cfg, params, n_prefill_slots=n_slots // 2,
                           n_decode_slots=n_slots - n_slots // 2,
                           max_len=max_len, page_size=page,
                           disagg_mode=kind.split("-", 1)[1], device=device,
                           **engine_kw)
    else:
        eng = ServingEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                            page_size=page, scheduler=kind, device=device,
                            **engine_kw)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
    done = eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [done[r].out_tokens for r in rids], eng, done, wall


def check_serve(cfg, eng, outs, prompts, max_tokens) -> dict:
    """What a served run must show on any device; returns its stats. A
    zero-copy serve makes no staging copy, and with the fixed scheduler and
    prefix sharing maps shared pages and makes a CoW copy; a copy-mode
    serve stages every admission and maps nothing."""
    s = eng.stats()
    assert all(len(o) == max_tokens for o in outs), "short generation"
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert len({tuple(o) for o in outs}) > 1, "every request decoded alike"
    if eng.offload_mode == "copy":
        assert s["staging_copies"] == len(prompts), s["staging_copies"]
        # the manager models KV bytes only: an arch without attention
        # layers (rwkv6) stages none
        has_kv = eng.mgr.kv_bytes_per_token > 0
        assert (s["sva"]["bytes_copied"] > 0) == has_kv
        assert s["sva"]["bytes_mapped"] == 0
    else:
        assert s["staging_copies"] == 0, "zero-copy serve made a staging copy"
    if eng._can_share and eng.sched is None:
        assert s["shared_admissions"] > 0 and s["prefill_tokens_saved"] > 0
        assert s["cow_page_copies"] > 0, "no CoW page copy was exercised"
    for entry in eng.cache:         # pools, and recurrent states
        assert all(torch.isfinite(t).all() for t in entry
                   if t.is_floating_point())
    return s


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_slots, max_len, new_tokens = 8, 1024, 32
    prompts = requests(cfg.vocab_size, np.random.default_rng(SEED))
    reset_launch_counts()
    outs, eng, done, wall = serve(cfg, params, "cuda", prompts, new_tokens,
                                  n_slots, max_len, PAGE)
    launches = _serve_launches()
    s = check_serve(cfg, eng, outs, prompts, new_tokens)
    steps = s["decode_steps"]
    assert launches["paged_attention_global"] == cfg.n_layers * steps, launches
    assert launches["flash_attention_fwd"] >= cfg.n_layers, launches
    ttft = [(r.first_token_at - r.submitted_at) * 1e3 for r in done.values()]
    pool_bytes = sum(kv.k_pool.numel() * kv.k_pool.element_size() * 2
                     for kv in eng.cache)
    emit("phase3 serve", arch=cfg.name, dtype=cfg.activation_dtype,
         n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         requests=len(prompts), prompt_lens=[len(p) for p in prompts],
         new_tokens=new_tokens, slots=n_slots, max_len=max_len, page=PAGE,
         kv_pool_mib=pool_bytes / 2**20,
         weights_gib=sum(t.numel() * t.element_size()
                         for t in _leaves(params)) / 2**30,
         init_s=init_s, wall_s=wall, tokens=s["tokens"],
         tokens_per_s=s["tokens"] / wall,
         ttft_ms_median=statistics.median(ttft), ttft_ms_max=max(ttft),
         prefill_s=s["prefill_s"], decode_s=s["decode_s"],
         decode_steps=steps, prefills=s["prefills"],
         staging_copies=s["staging_copies"],
         prefill_tokens_saved=s["prefill_tokens_saved"],
         shared_admissions=s["shared_admissions"],
         cow_page_copies=s["cow_page_copies"],
         table_uploads_full=s["table_uploads_full"],
         table_uploads_delta=s["table_uploads_delta"],
         table_upload_bytes=s["table_upload_bytes"], launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    figures = _serve_figures(s, done, wall)
    return (launches, (cfg, params, prompts, new_tokens, n_slots, max_len),
            outs, figures)


def _serve_launches() -> dict:
    """Launch counts of a bf16 serve since the last reset, with the flash
    kernel's wgmma launches; every flash launch must be one."""
    from repro_torch.kernels import flash_attention_fwd, launch_counts
    launches = launch_counts()
    launches["flash_attention_fwd_wgmma"] = flash_attention_fwd.wgmma_launches
    assert (launches["flash_attention_fwd_wgmma"]
            == launches["flash_attention_fwd"]), launches
    return launches


def _serve_figures(s, done, wall) -> dict:
    ttft = [(r.first_token_at - r.submitted_at) * 1e3 for r in done.values()]
    return dict(wall_s=wall, tokens_per_s=s["tokens"] / wall,
                ttft_ms_median=statistics.median(ttft), ttft_ms_max=max(ttft),
                prefill_s=s["prefill_s"],
                decode_ms_per_step=s["decode_s"] / s["decode_steps"] * 1e3)


def phase_copy_serve(cfg, params, prompts, new_tokens, n_slots, max_len,
                     zero_copy_outs, zero_copy_figures) -> dict:
    """The phase-3 requests on the copy-mode engine: per-slot pools, one
    exact-length B=1 prefill and one staging copy per admission, the
    per-slot decode kernel, a full table upload every step. Served in turns
    with zero-copy (phase 3's serve, copy, copy, zero-copy), so the two
    modes' figures share the host's state."""
    from repro_torch.kernels import reset_launch_counts
    run = lambda **kw: serve(cfg, params, "cuda", prompts, new_tokens,
                             n_slots, max_len, PAGE, **kw)
    reset_launch_counts()
    outs, eng, done, wall = run(offload_mode="copy")
    launches = _serve_launches()
    s = check_serve(cfg, eng, outs, prompts, new_tokens)
    steps = s["decode_steps"]
    assert s["staging_copies"] == n_slots == len(prompts), s["staging_copies"]
    assert launches["paged_attention"] == cfg.n_layers * steps, launches
    assert launches["paged_attention_global"] == 0, launches
    assert launches["flash_attention_fwd"] >= cfg.n_layers * len(prompts), \
        launches
    copy_figures = [_serve_figures(s, done, wall)]
    _, eng2, done2, wall2 = run(offload_mode="copy")
    copy_figures.append(_serve_figures(eng2.stats(), done2, wall2))
    _, eng3, done3, wall3 = run()
    zero_copy_figures = [zero_copy_figures,
                         _serve_figures(eng3.stats(), done3, wall3)]
    # What the staging path moves on the device per admission: the fresh
    # single-sequence cache (zeroed, then rewritten by the prefill), its
    # clone, and the write into the batch slot, each a whole per-slot cache.
    single = sum(t.numel() * t.element_size()
                 for kv in eng.cache for t in kv) // n_slots
    same = sum(a == b for o, z in zip(outs, zero_copy_outs)
               for a, b in zip(o, z))
    emit("phase3c copy serve", arch=cfg.name, offload_mode="copy",
         requests=len(prompts), new_tokens=new_tokens, slots=n_slots,
         max_len=max_len, page=PAGE, turns="zero_copy copy copy zero_copy",
         copy=copy_figures, zero_copy=zero_copy_figures,
         decode_steps=steps, prefills=s["prefills"],
         staging_copies=s["staging_copies"],
         table_uploads_full=s["table_uploads_full"],
         table_upload_bytes=s["table_upload_bytes"],
         modeled_bytes_copied=s["sva"]["bytes_copied"],
         modeled_bytes_mapped=s["sva"]["bytes_mapped"],
         device_bytes_single_cache=single * len(prompts),
         device_bytes_clone=single * len(prompts),
         device_bytes_slot_write=single * len(prompts),
         tokens_equal_to_zero_copy=same,
         tokens_total=sum(len(o) for o in outs),
         requests_identical_to_zero_copy=sum(
             o == z for o, z in zip(outs, zero_copy_outs)),
         first_tokens_equal=sum(o[0] == z[0]
                                for o, z in zip(outs, zero_copy_outs)),
         launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches


def _other_launches_zero(launches, used) -> None:
    assert all(n == 0 for k, n in launches.items()
               if k not in used and not k.endswith("_wgmma")), launches


def phase_scheduled_serve(cfg, params, prompts, new_tokens, n_slots, max_len,
                          fixed_outs) -> dict:
    """The phase-3 requests through the continuous engine and the
    disaggregated engine in share and copy mode, each at n_slots (disagg:
    half prefill, half decode). Chunked prefill runs the prefix path (no
    flash launch) and every masked decode call launches the paged decode
    kernel once a layer at full slot width. The continuous engine's pool
    holds the larger of the longest request's pages and half the pages the
    requests hold at their end, shrunk by a quarter (and said so on the
    line) until it preempts and resumes. The manager's least pool is one
    slot's table, so that engine's max_len is the longest request's pages
    (33 pages of 16, not phase 3's 64): with 64 pages these requests wait
    for room and are never preempted. Tokens equal to phase 3's fixed
    serve are counted, not asserted: in bf16 chunked prefill and flash are
    two prefill paths."""
    from repro_torch.kernels import reset_launch_counts
    ends = [-(-(len(p) + new_tokens) // PAGE) for p in prompts]
    floor = max(ends)
    launches_by_kind, outs_by_kind = {}, {}
    for kind in ("continuous", "disagg-share", "disagg-copy"):
        kw, ml = {}, max_len
        if kind == "continuous":
            kw["pool_pages"] = max(floor, sum(ends) // 2)
            ml = floor * PAGE
        shrunk_from = []
        while True:
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            outs, eng, done, wall = serve(cfg, params, "cuda", prompts,
                                          new_tokens, n_slots, ml, PAGE,
                                          kind=kind, **kw)
            launches = _serve_launches()
            sched = eng.stats()["sched"]
            if (kind != "continuous" or kw["pool_pages"] <= floor
                    or (sched["preemptions"] > 0 and sched["resumes"] > 0)):
                break
            shrunk_from.append(kw["pool_pages"])
            kw["pool_pages"] = max(floor, kw["pool_pages"] * 3 // 4)
        s = check_serve(cfg, eng, outs, prompts, new_tokens)
        steps = s["decode_steps"]
        assert launches["paged_attention_global"] == cfg.n_layers * steps, \
            (kind, launches)
        assert launches["flash_attention_fwd"] == 0, (kind, launches)
        _other_launches_zero(launches, ("paged_attention_global",))
        row = dict(kind=kind, arch=cfg.name, dtype=cfg.activation_dtype,
                   requests=len(prompts), new_tokens=new_tokens,
                   slots=n_slots, max_len=ml, page=PAGE,
                   pool_pages=kw.get("pool_pages", eng.mgr.pool.n_pages),
                   pool_shrunk_from=shrunk_from,
                   pages_at_end=sum(ends), tokens=s["tokens"],
                   **_serve_figures(s, done, wall),
                   decode_s=s["decode_s"], decode_steps=steps,
                   prefills=s["prefills"], sched=s["sched"],
                   transfer=s.get("transfer"), disagg=s.get("disagg"),
                   staging_copies=s["staging_copies"],
                   shared_admissions=s["shared_admissions"],
                   prefill_tokens_saved=s["prefill_tokens_saved"],
                   cow_page_copies=s["cow_page_copies"],
                   tokens_equal_to_fixed=sum(
                       a == b for o, f in zip(outs, fixed_outs)
                       for a, b in zip(o, f)),
                   tokens_total=sum(len(o) for o in outs),
                   requests_identical_to_fixed=sum(
                       o == f for o, f in zip(outs, fixed_outs)),
                   launches=launches,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        if kind == "disagg-copy":
            # The same chunks and decode calls as share mode over copied
            # pages: the same tokens, bit for bit.
            row["identical_to_share"] = outs == outs_by_kind["disagg-share"]
        emit("phase3d scheduled serve", **row)
        if kind == "continuous":
            assert s["sched"]["preemptions"] > 0, row
            assert s["sched"]["resumes"] > 0, row
        else:
            t = s["transfer"]
            assert s["disagg"]["transfers"] == t["transfers"] == len(prompts), row
            if kind == "disagg-share":
                assert t["payload_bytes"] == 0 and t["pages_copied"] == 0, row
                assert t["pages_shared"] > 0, row
            else:
                assert t["payload_bytes"] > 0 and t["pages_copied"] > 0, row
                assert t["pages_shared"] == 0, row
                assert row["identical_to_share"], row
        launches_by_kind[kind] = launches["paged_attention_global"]
        outs_by_kind[kind] = outs
    return launches_by_kind


# ------------------------------------------------------------------ phase 3e

DENSE_ARCHS = ("qwen2-7b", "llama3.2-3b", "gemma2-2b")
# decode-against-prefill length: gemma2's passes its 4096-token window and
# is no multiple of it, so its rings wrap unaligned
CONSISTENCY_S = {"llama3.2-1b": 1000, "qwen2-7b": 1000, "llama3.2-3b": 1000,
                 "gemma2-2b": 4500, "olmoe-1b-7b": 1000,
                 # S and S + 1 both lengths the reference's chunking takes:
                 # rwkv6 1023 = 31 x 33 and 1024 = 32 x 32; mamba one chunk
                 "rwkv6-3b": 1023, "jamba-1.5-large-398b": 500,
                 "seamless-m4t-medium": 1000, "llama-3.2-vision-90b": 1000,
                 # at KIMI_NO_DROP_CF a prefill's expert buffers are (384,
                 # B S, 7168): 5.5 GB each at B 2 x 501
                 "kimi-k2-1t-a32b": 500}
LOGIT_REL = 5e-2        # max|d logits| / max|logit| in bf16
LONG_MAX_LEN = 8192     # gemma2's serve: 4 slots of 512 pages
# The reference's init draws wq and wk at std heads**-0.5 (its fan-in is
# the heads axis), so attention is sharp and a deep random model can
# amplify a rounding difference to O(1) in its logits: no end-to-end
# comparison of two bf16 paths holds on it (tests/test_torch_init.py pins
# this on the reference's own init at full depth). Where the weights as
# built move their logits by CHAOTIC or more when the embeddings move by
# 1/128 (_input_sensitivity), the end-to-end decode-against-prefill is a
# reading, not a gate, and the serves run on the same weights with wq and
# wk scaled by QK_SCALE (attention logits / 100), on which attention is
# near uniform: their first-token check cannot see a misplaced KV page.
# The per-layer check runs on the weights as built and gates every arch.
CHAOTIC = 0.5
QK_SCALE = 0.1


def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max().item()
            / (ref.float().abs().max().item() + 1e-9))


def _qk_scaled(params, scale: float = QK_SCALE):
    """The same weights with every attention's wq and wk scaled, self- and
    cross-attention alike (new tensors for those two; every other leaf
    shared)."""
    def layer(p):
        return dict(p, **{k: dict(p[k], wq=p[k]["wq"] * scale,
                                  wk=p[k]["wk"] * scale)
                          for k in ("attn", "xattn") if k in p})
    out = dict(params, blocks=[{k: layer(v) for k, v in blk.items()}
                               for blk in params["blocks"]])
    if "first" in params:
        out["first"] = {k: layer(v) for k, v in params["first"].items()}
    return out


def _src_len(cfg) -> int:
    """Rows of a cross-attention's source at full width: the image tokens,
    or the reference's stubbed audio-frame count for an encoder-decoder."""
    from repro_torch.models.model import ENCDEC_SRC_LEN
    return cfg.n_image_tokens or ENCDEC_SRC_LEN


def _cross_inputs(cfg, B: int, seed=None) -> dict:
    """A prefill's image embeddings or encoder input for B rows of
    ``_src_len(cfg)``: random from ``seed``, or zeros (as the engine feeds
    them) without one; nothing for a decoder alone."""
    from repro_torch.models.params import torch_dtype
    if not (cfg.is_encdec or cfg.n_image_tokens):
        return {}
    shape = (B, _src_len(cfg), cfg.d_model)
    if seed is None:
        x = torch.zeros(shape, device="cuda")
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(shape, generator=g, device="cuda")
    return {"img_x" if cfg.n_image_tokens else "enc_x":
            x.to(torch_dtype(cfg.activation_dtype))}


def _cross_x(cfg, params, B: int, seed: int):
    """What a prefill's cross-attention attends over for random inputs
    from ``seed`` (the encoder's output, or the image embeddings); None for
    a decoder alone."""
    from repro_torch.models.model import _cross_source
    with torch.no_grad():
        return _cross_source(cfg, params, _cross_inputs(cfg, B, seed))


def _input_sensitivity(cfg, params, S: int, B: int = 2) -> float:
    """rel of the last logits of a prefill of S tokens when each element
    of its embeddings moves by one part in 128 (a bf16 rounding step or
    two): the model's own gain on a rounding difference. A cross-attention
    arch attends over random image embeddings or encoder input, the same
    in both prefills."""
    from repro_torch.models.blocks import FwdCtx, apply_layer
    from repro_torch.models.layers import logits_fn, rmsnorm
    from repro_torch.models.model import _embed_in, layers
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device="cuda")
    sign = torch.randint(0, 2, (B, S, cfg.d_model), generator=g,
                         device="cuda") * 2 - 1
    ctx = FwdCtx(cfg=cfg, mode="prefill",
                 cross_x=_cross_x(cfg, params, B, SEED + 4))
    out = []
    with torch.no_grad():
        x0 = _embed_in(cfg, params, toks)
        for x in (x0, (x0.float() * (1 + sign / 128)).to(x0.dtype)):
            for kind, p in layers(cfg, params):
                x, _ = apply_layer(kind, p, x, ctx, None)
            x = rmsnorm(x[:, -1:], params["final_ln"], cfg.norm_eps)
            out.append(logits_fn(params["embed"], x, cfg.logit_softcap))
    return _rel(out[1], out[0])


def _serving_cache(cfg, S: int, B: int, seed: int):
    """B rows of S + 1 random tokens and, for their first S, the serving
    layout (the global pool, and rings for sliding-window layers, cross K/V
    of ``_src_len(cfg)`` rows) with its tables and lengths."""
    from repro_torch.models import init_cache
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device="cuda")
    n_pages = -(-(S + 1) // PAGE)
    cache = init_cache(cfg, B, n_pages * PAGE, PAGE,
                       global_pages=B * n_pages, device="cuda",
                       src_len=_src_len(cfg))
    tables = torch.arange(B * n_pages, dtype=torch.int32,
                          device="cuda").view(B, n_pages)
    lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
    return toks, cache, tables, lengths


def _layerwise_decode_vs_prefill(cfg, params, S: int, B: int = 2) -> float:
    """Decode against prefill one layer at a time, each layer fed the same
    hidden states: every layer of a prefill of S + 1 tokens (no cache)
    against the same layer's prefill of the first S into the serving
    layout followed by one decode step of token S. Returns the largest
    rel of a layer's update (output minus input) at token S. No error
    carries from layer to layer, so this holds on weights whose
    end-to-end output rounding scrambles. A cross-attention arch attends
    over random image embeddings or encoder input in all three."""
    from repro_torch.core.serving.engine import (_build_prefill_view,
                                                 _install_tables,
                                                 _merge_prefill_view)
    from repro_torch.models.blocks import FwdCtx, apply_layer
    from repro_torch.models.model import _embed_in, by_layer, flat, layers
    toks, cache, tables, lengths = _serving_cache(cfg, S, B, SEED + 1)
    view = by_layer(cfg, _build_prefill_view(cache, tables, lengths))
    cross_x = _cross_x(cfg, params, B, SEED + 5)
    full = FwdCtx(cfg=cfg, mode="prefill", cross_x=cross_x)
    pre = FwdCtx(cfg=cfg, mode="prefill", seq_lengths=lengths,
                 cross_x=cross_x)
    dec = FwdCtx(cfg=cfg, mode="decode", q_offset=lengths)
    worst = 0.0
    with torch.no_grad():
        xs = [_embed_in(cfg, params, toks)]     # each layer's input
        for li, (kind, p) in enumerate(layers(cfg, params)):
            x = xs[-1]
            # a recurrent state or a cross K/V comes back new (a pool is
            # written in place)
            _, view[li] = apply_layer(kind, p, x[:, :S].contiguous(), pre,
                                      view[li])
            xs.append(apply_layer(kind, p, x, full, None)[0])
        _merge_prefill_view(cache, flat(cfg, view),
                            torch.arange(B, device="cuda"))
        kv = by_layer(cfg, _install_tables(cache, tables, lengths))
        for li, (kind, p) in enumerate(layers(cfg, params)):
            x, x_next = xs[li][:, S:], xs[li + 1][:, S:]
            y, _ = apply_layer(kind, p, x.contiguous(), dec, kv[li])
            worst = max(worst, _rel(y - x, x_next - x))
    return worst


def _decode_vs_prefill(cfg, params, S: int, B: int = 2) -> dict:
    """forward_prefill of S tokens into the serving layout, then one
    forward_decode, against the last logits of a prefill of S + 1 tokens:
    the card's tests/test_decode_consistency.py (a cross-attention arch
    with random image embeddings or encoder input)."""
    from repro_torch.core.serving.engine import (_build_prefill_view,
                                                 _install_tables,
                                                 _merge_prefill_view)
    from repro_torch.models import forward_decode, forward_prefill
    from repro_torch.models.model import is_state, per_slot
    toks, cache, tables, lengths = _serving_cache(cfg, S, B, SEED)
    extra = _cross_inputs(cfg, B, SEED + 5)
    with torch.no_grad():
        ref, _ = forward_prefill(cfg, params, {"tokens": toks, **extra},
                                 None)
        view = _build_prefill_view(cache, tables, lengths)
        _, view = forward_prefill(cfg, params, {"tokens": toks[:, :S],
                                                "lengths": lengths, **extra},
                                  view)
        _merge_prefill_view(cache, view, torch.arange(B, device="cuda"))
        dec, _ = forward_decode(cfg, params, toks[:, S:], lengths,
                                _install_tables(cache, tables, lengths))
    rings = [kv for kv in cache if per_slot(kv) and not is_state(kv)]
    return dict(rel=_rel(dec, ref),
                ring_tokens=rings[0].capacity if rings else None,
                ring_layers=len(rings))


def _consistency(cfg, params, S: int,
                 phase: str = "phase3e decode-vs-prefill"):
    """Phase 3e (a) for one arch, on the weights as built. ``layer_rel``
    gates every arch. The end-to-end ``rel`` gates an arch whose weights
    are not chaotic (``sensitivity`` below CHAOTIC); on chaotic weights it
    is a reading (~1), and the serve runs on their q/k-scaled copy, which
    is returned with the row."""
    row = dict(arch=cfg.name, S=S, B=2,
               sensitivity=_input_sensitivity(cfg, params, S),
               layer_rel=_layerwise_decode_vs_prefill(cfg, params, S),
               **_decode_vs_prefill(cfg, params, S))
    row["chaotic"] = row["sensitivity"] >= CHAOTIC
    served = params
    if row["chaotic"]:
        served = _qk_scaled(params)
        row.update(qk_scale=QK_SCALE,
                   sensitivity_scaled=_input_sensitivity(cfg, served, S))
    if cfg.moe is not None:
        row["capacity_factor"] = cfg.moe.capacity_factor
    emit(phase, **row)
    assert row["layer_rel"] < LOGIT_REL, row
    assert row["chaotic"] or row["rel"] < LOGIT_REL, row
    return served, row


@contextlib.contextmanager
def _routes():
    """While a model runs, records every MoE routing's top-K experts in
    call order, each token's K choices sorted ((T, K), left on the card)."""
    from repro_torch.models import moe
    real, rec = moe.route, []

    def recorded(p, x2, cfg):
        experts, gates = real(p, x2, cfg)
        rec.append(experts.sort(dim=-1).values)
        return experts, gates
    with mock.patch.object(moe, "route", recorded):
        yield rec


@contextlib.contextmanager
def _first_logits():
    """While a serve runs, records every prefill call of the engine as
    (each row's full prompt length, its tokens, its last logits, its
    tokens' expert choices in each MoE layer): the serve's own first-token
    logits and the routing that led to them."""
    from repro_torch.core.serving import engine as eng_mod
    real, rows = eng_mod.forward_prefill, []

    def prefill(cfg, params, batch, cache, **mi):
        with _routes() as routes:
            logits, cache = real(cfg, params, batch, cache, **mi)
        toks, lens = batch["tokens"], batch.get("lengths")
        lens = ([toks.shape[1]] * toks.shape[0] if lens is None
                else lens.tolist())
        pre = batch.get("prefix_lens")
        pre = [0] * len(lens) if pre is None else pre.tolist()
        B = toks.shape[0]
        for i, (n, k) in enumerate(zip(lens, pre)):
            choices = [r.view(B, -1, r.shape[-1])[i, :n] for r in routes]
            rows.append((k + n, toks[i, :n].tolist(), logits[i, -1],
                         choices))
        return logits, cache
    with mock.patch.object(eng_mod, "forward_prefill", prefill):
        yield rows


def _first_token_check(cfg, params, prompts, served_rows,
                       gate: bool = True, last_token: bool = False) -> tuple:
    """Each request's first-token logits from the serve (the prefill row
    of its length whose tokens end its prompt) against a B=1
    forward_prefill of its prompt on the card: the engine's padded,
    table-driven (mixed-layout) prefill, where bf16 tokens cannot be
    compared. Returns (rels, flips): ``flips`` counts, a request, the
    (token, MoE layer) pairs whose expert set differs between the two
    prefills (0 without MoE layers; with ``last_token``, the prompt's last
    token's alone). With ``gate`` False a reading only. A
    cross-attention arch's B=1 prefill takes the zero source the engine's
    does."""
    from repro_torch.models import forward_prefill
    rels, flips = [], []
    for p in prompts:
        served = [(lg, ch) for n, toks, lg, ch in served_rows
                  if n == len(p) and p[n - len(toks):] == toks]
        lg, choices = served[-1]
        with torch.no_grad(), _routes() as routes:
            ref, _ = forward_prefill(cfg, params, {"tokens": torch.tensor(
                [p], device="cuda"), **_cross_inputs(cfg, 1)}, None)
        rels.append(_rel(lg, ref[0, -1]))
        keep = slice(-1, None) if last_token else slice(None)
        flips.append(sum(int((c[keep] != r[-len(c):][keep]).any(-1).sum())
                         for c, r in zip(choices, routes)))
    assert not gate or max(rels) < LOGIT_REL, rels
    return rels, flips


def _long_requests(vocab: int, rng, n: int = 4, lo: int = 4500,
                   hi: int = 6000):
    return [rng.integers(0, vocab, size=int(L)).tolist()
            for L in rng.integers(lo, hi + 1, size=n)]


def _dense_serve(cfg, params, prompts, new_tokens, n_slots, max_len,
                 offload_mode="zero_copy", **engine_kw) -> tuple:
    """One fixed-scheduler serve at full width with its launch counts and
    each request's first-token logits."""
    from repro_torch.kernels import reset_launch_counts
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _first_logits() as first:
        outs, eng, done, wall = serve(cfg, params, "cuda", prompts,
                                      new_tokens, n_slots, max_len, PAGE,
                                      offload_mode=offload_mode, **engine_kw)
    launches = _serve_launches()
    s = check_serve(cfg, eng, outs, prompts, new_tokens)
    row = dict(offload_mode=offload_mode, **_serve_figures(s, done, wall),
               decode_s=s["decode_s"], decode_steps=s["decode_steps"],
               prefills=s["prefills"], staging_copies=s["staging_copies"],
               shared_admissions=s["shared_admissions"],
               cow_page_copies=s["cow_page_copies"], launches=launches,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return outs, eng, row, first


def phase_dense_archs(control_params) -> dict:
    """qwen2-7b, llama3.2-3b and gemma2-2b as get_config gives them (bf16,
    depth not cut, random weights from SEED built on the card), one at a
    time: (a) decode against prefill on the weights as built
    (llama3.2-1b, phase 3's model, as the control): layer by layer, and
    end to end, a gate only where they are not chaotic; (b) on them or,
    where they are chaotic, on them with wq and wk scaled by QK_SCALE, a
    zero-copy serve, with its launch counts: the global
    decode kernel once a global-pool layer a step, the per-slot one once a
    ring layer a step, flash on wgmma; qwen2 and llama3.2-3b take phase 3's
    requests and copy serves in turns, gemma2 four prompts of 4500-6000
    tokens over rings of 4096 (its copy mode must raise); (c) every
    request's first-token logits against a B=1 prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.serving.engine import ServingEngine
    from repro_torch.models import init_params
    _consistency(get_config("llama3.2-1b"), control_params,
                 CONSISTENCY_S["llama3.2-1b"])
    launches_by_arch = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        params = init_params(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params, _ = _consistency(cfg, params, CONSISTENCY_S[arch])
        kinds = cfg.layer_kinds()
        n_ring = sum(k == "attn_mlp_local" for k in kinds)
        n_global = len(kinds) - n_ring
        rng = np.random.default_rng(SEED)
        if n_ring:
            prompts = _long_requests(cfg.vocab_size, rng)
            assert min(map(len, prompts)) > cfg.sliding_window
            n_slots, max_len = 4, LONG_MAX_LEN
        else:
            prompts = requests(cfg.vocab_size, rng)
            n_slots, max_len = 8, 1024
        new_tokens = 32
        outs, eng, row, first = _dense_serve(cfg, params, prompts, new_tokens,
                                             n_slots, max_len)
        launches = row["launches"]
        steps = row["decode_steps"]
        assert launches["paged_attention_global"] == n_global * steps, launches
        assert launches["paged_attention"] == n_ring * steps, launches
        assert launches["flash_attention_fwd"] >= len(kinds), launches
        rings = [kv for kv in eng.cache if kv.k_pool.dim() == 5]
        assert len(rings) == n_ring
        if n_ring:
            assert all(kv.capacity == cfg.sliding_window for kv in rings)
            assert all(int(kv.length.min()) > kv.capacity for kv in rings)
        del eng
        rels, _ = _first_token_check(cfg, params, prompts, first)
        row.update(arch=arch, dtype=cfg.activation_dtype,
                   n_layers=cfg.n_layers, d_model=cfg.d_model,
                   heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
                   d_head=cfg.d_head, vocab=cfg.vocab_size,
                   global_layers=n_global, ring_layers=n_ring,
                   ring_tokens=rings[0].capacity if rings else None,
                   requests=len(prompts),
                   prompt_lens=[len(p) for p in prompts],
                   new_tokens=new_tokens, slots=n_slots, max_len=max_len,
                   page=PAGE, init_s=init_s,
                   weights_gib=sum(t.numel() * t.element_size()
                                   for t in _leaves(params)) / 2**30,
                   first_token_rel=rels)
        emit("phase3e serve", **row)
        launches_by_arch[arch] = launches
        if n_ring:
            try:
                ServingEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                              page_size=PAGE, offload_mode="copy",
                              device="cuda")
            except NotImplementedError as e:
                emit("phase3e copy serve", arch=arch, raises=repr(e)[:120])
            else:
                raise AssertionError(f"{arch}: copy mode past the window "
                                     "served")
        else:
            copy_rows = []
            for mode in ("copy", "copy", "zero_copy"):
                c_outs, c_eng, c_row, c_first = _dense_serve(
                    cfg, params, prompts, new_tokens, n_slots, max_len, mode)
                del c_eng
                if mode == "copy":
                    c_launches = c_row["launches"]
                    assert (c_launches["paged_attention"]
                            == cfg.n_layers * c_row["decode_steps"]), c_launches
                    assert c_launches["paged_attention_global"] == 0
                    c_row["first_token_rel"] = _first_token_check(
                        cfg, params, prompts, c_first)[0]
                    c_row["tokens_equal_to_zero_copy"] = sum(
                        a == b for o, z in zip(c_outs, outs)
                        for a, b in zip(o, z))
                copy_rows.append(c_row)
            emit("phase3e copy serve", arch=arch,
                 turns="zero_copy copy copy zero_copy", serves=copy_rows)
            launches_by_arch[arch + " copy"] = copy_rows[0]["launches"]
        del params
        torch.cuda.empty_cache()
    return launches_by_arch


# ------------------------------------------------------------------ phase 3f

# tests/test_decode_consistency.py's capacity for MoE archs: no choice drops
# in a prefill or a decode batch, so the two paths compute one function.
MOE_NO_DROP_CF = 16.0


@contextlib.contextmanager
def _moe_drops():
    """While a serve runs, counts every MoE call's (token, choice) pairs
    and those dropped past capacity, split into decode (one token a row)
    and prefill calls. The counts stay on the card until read."""
    from repro_torch.models import blocks
    real, rec = blocks.moe_ffn, {"prefill": [], "decode": []}

    def counted(p, x, cfg, *mi, **kw):
        out, keep = real(p, x, cfg, *mi, return_keep=True, **kw)
        rec["decode" if x.shape[1] == 1 else "prefill"].append(
            (keep.numel(), (~keep).sum()))
        return out
    with mock.patch.object(blocks, "moe_ffn", counted):
        yield rec


def _drop_shares(rec) -> dict:
    out = {}
    for mode, calls in rec.items():
        pairs = sum(n for n, _ in calls)
        dropped = int(sum(d for _, d in calls)) if calls else 0
        out[mode] = dict(calls=len(calls), pairs=pairs, dropped=dropped,
                         share=dropped / pairs if pairs else None)
    return out


SERVE_TURNS = ("zero_copy", "copy", "copy", "zero_copy")
TURN_SLOTS, TURN_MAX_LEN, TURN_NEW_TOKENS = 8, 1024, 32


def _serve_turns(cfg, params, prompts, decode_layers: int, flash_ok,
                 prefills=None, n_moe: int = 0, **engine_kw) -> tuple:
    """The requests served in SERVE_TURNS (TURN_SLOTS slots of
    TURN_MAX_LEN, TURN_NEW_TOKENS new tokens), each by ``_dense_serve``,
    with its launches held: the global decode kernel (copy mode: the
    per-slot one) ``decode_layers`` times a step, flash as
    ``flash_ok(row)`` says, no other kernel; the prefill calls
    ``prefills[mode]`` where given; and, with ``n_moe`` MoE layers, the
    dropped shares, every decode choice counted. Returns (each turn's row,
    with its tokens equal to the first zero-copy serve's; each turn's
    first-token rows; the launches of each mode's first turn)."""
    rows, firsts, by_mode = [], [], {}
    for mode in SERVE_TURNS:
        with _moe_drops() as rec:
            outs, eng, row, first = _dense_serve(
                cfg, params, prompts, TURN_NEW_TOKENS, TURN_SLOTS,
                TURN_MAX_LEN, mode, **engine_kw)
        del eng
        launches, steps = row["launches"], row["decode_steps"]
        used = ("paged_attention_global" if mode == "zero_copy"
                else "paged_attention")
        where = (cfg.name, mode, row["prefills"], launches)
        assert launches[used] == decode_layers * steps, where
        assert flash_ok(row), where
        _other_launches_zero(launches, (used, "flash_attention_fwd"))
        assert prefills is None or row["prefills"] == prefills[mode], where
        if n_moe:
            row["drops"] = drops = _drop_shares(rec)
            assert drops["decode"]["pairs"] == (
                n_moe * steps * TURN_SLOTS * cfg.moe.experts_per_token)
        if not rows:
            zc_outs = outs
        row["tokens_equal_to_first_zero_copy"] = sum(
            a == b for o, z in zip(outs, zc_outs) for a, b in zip(o, z))
        rows.append(row)
        firsts.append(first)
        by_mode.setdefault(mode, launches)
    return rows, firsts, by_mode


def phase_moe_arch() -> dict:
    """olmoe-1b-7b as get_config gives it (bf16, 16 attn_moe layers, random
    weights from SEED built on the card): (a) decode against prefill, layer
    by layer and end to end, at capacity factor MOE_NO_DROP_CF; (b) on the
    weights as built or, where chaotic, q/k-scaled, a zero-copy serve of
    phase 3's requests at the published capacity (launch counts, the
    dropped share of (token, choice) pairs in prefill and in decode, ms a
    step, tokens/s, TTFT, peak GiB) and its copy serves in turns; (c) each
    request's first-token logits against a B=1 prefill on a zero-copy
    serve at MOE_NO_DROP_CF."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(MOE_ARCH)
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_NO_DROP_CF))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params, _ = _consistency(no_drop, params, CONSISTENCY_S[MOE_ARCH],
                             phase="phase3f decode-vs-prefill")
    prompts = requests(cfg.vocab_size, np.random.default_rng(SEED))
    turns, firsts, launches_by_kind = _serve_turns(
        cfg, params, prompts, cfg.n_layers,
        lambda r: r["launches"]["flash_attention_fwd"] >= cfg.n_layers,
        n_moe=cfg.n_layers)
    for row, first in zip(turns, firsts):
        row["first_token_rel_reading"] = _first_token_check(
            cfg, params, prompts, first, gate=False)[0]
    row = turns[0]
    row.update(arch=MOE_ARCH, dtype=cfg.activation_dtype,
               n_layers=cfg.n_layers, d_model=cfg.d_model,
               heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", d_head=cfg.d_head,
               experts=cfg.moe.n_experts, top_k=cfg.moe.experts_per_token,
               d_ff=cfg.moe.d_ff, capacity_factor=cfg.moe.capacity_factor,
               vocab=cfg.vocab_size, requests=len(prompts),
               prompt_lens=[len(p) for p in prompts],
               new_tokens=TURN_NEW_TOKENS, slots=TURN_SLOTS,
               max_len=TURN_MAX_LEN, page=PAGE, init_s=init_s,
               weights_gib=sum(t.numel() * t.element_size()
                               for t in _leaves(params)) / 2**30)
    emit("phase3f serve", **row)
    emit("phase3f copy serve", arch=MOE_ARCH,
         turns="zero_copy copy copy zero_copy", serves=turns[1:])
    # (c): no choice drops in the serve's prefill nor in a B=1 prefill
    outs, eng, row, first = _dense_serve(no_drop, params, prompts,
                                         TURN_NEW_TOKENS, TURN_SLOTS,
                                         TURN_MAX_LEN)
    del eng
    assert row["launches"]["paged_attention_global"] == \
        cfg.n_layers * row["decode_steps"], row["launches"]
    rels, flips = _first_token_check(no_drop, params, prompts, first)
    emit("phase3f first-token", arch=MOE_ARCH,
         capacity_factor=MOE_NO_DROP_CF, first_token_rel=rels,
         first_token_flips=flips,
         **{k: row[k] for k in ("decode_ms_per_step", "tokens_per_s",
                                "ttft_ms_median", "peak_mem_gib")})
    del params
    torch.cuda.empty_cache()
    return launches_by_kind


# ------------------------------------------------------------------ phase 3g

RECURRENT_ARCHS = ("rwkv6-3b", "jamba-1.5-large-398b")
# jamba's cut: the first five layers of its period of 8 (mamba, mamba_moe,
# mamba, mamba_moe, attn), every layer kind at its published width and the
# shortest cut that holds the attention layer; one period is 84 GiB of
# bf16, past the card.
JAMBA_CUT = 5


def _recurrent_cfg(arch: str):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_CUT,
                                  block_pattern=cfg.block_pattern[:JAMBA_CUT])
    return cfg


def _recurrent_requests(cfg, rng, n: int = 8) -> list:
    """n prompts at lengths the reference's chunking takes (its reshape
    fails elsewhere, and so does the port's): for rwkv6 multiples of 32 in
    192-480 (T // 32 divides T), for jamba's mamba layers 100-511 (one
    chunk under 512). The first two lengths recur once each, so the
    zero-copy engine prefills 8 requests in n - 2 exact-length groups."""
    lens = (np.arange(192, 481, 32) if cfg.ssm is None
            else np.arange(100, 512))
    lens = [int(x) for x in rng.choice(lens, n - 2, replace=False)]
    lens += lens[:2]
    return [rng.integers(0, cfg.vocab_size, size=L).tolist() for L in lens]


def phase_recurrent_archs() -> dict:
    """rwkv6-3b as get_config gives it and jamba at full width on JAMBA_CUT
    layers (bf16, random weights from SEED built on the card), one at a
    time: (a) decode against prefill, layer by layer (a recurrent layer's
    chunked scan against its step recurrence) and end to end where not
    chaotic, jamba at capacity factor MOE_NO_DROP_CF; (b) on the weights as
    built or, where chaotic, q/k-scaled, a zero-copy serve, then copy, copy
    and zero-copy in turns, at the published capacity: figures, exact-
    length prefills against requests, staging copies, launches (rwkv6 none
    of any attention kernel; jamba one decode a step and one flash a
    prefill, its one attention layer), jamba's dropped shares; (c) each
    request's first-token logits against a B=1 prefill on the first
    zero-copy serve (jamba on one more at MOE_NO_DROP_CF, where no choice
    drops), with the tokens whose expert set differs between the serve's
    prefill and the B=1 one counted: a gate for every request whose
    prefill made the B=1 prefill's choices, a reading where a choice
    flipped (a rounding of another batch's matmul shapes that moves one
    choice changes that token's MoE output, and the recurrent state carries
    it to every later token)."""
    from repro_torch.models import init_params
    launches_by_arch = {}
    for arch in RECURRENT_ARCHS:
        cfg = _recurrent_cfg(arch)
        no_drop = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         capacity_factor=MOE_NO_DROP_CF))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        params = init_params(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gib = sum(t.numel() * t.element_size()
                          for t in _leaves(params)) / 2**30
        params, cons = _consistency(no_drop, params, CONSISTENCY_S[arch],
                                    phase="phase3g decode-vs-prefill")
        prompts = _recurrent_requests(cfg, np.random.default_rng(SEED))
        kinds = cfg.layer_kinds()
        n_attn = sum(k == "attn" for k in kinds)
        n_moe = sum(k == "mamba_moe" for k in kinds)
        turns, firsts, by_mode = _serve_turns(
            cfg, params, prompts, n_attn,
            lambda r: (r["launches"]["flash_attention_fwd"]
                       == n_attn * r["prefills"]),
            prefills={"copy": len(prompts),
                      "zero_copy": len({len(p) for p in prompts})},
            n_moe=n_moe)
        launches_by_arch.update({f"{arch} {m}": n
                                 for m, n in by_mode.items()})
        row = turns[0]
        row.update(arch=arch, dtype=cfg.activation_dtype,
                   n_layers=cfg.n_layers, layer_kinds=list(kinds),
                   d_model=cfg.d_model,
                   heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", d_head=cfg.d_head,
                   vocab=cfg.vocab_size, requests=len(prompts),
                   prompt_lens=[len(p) for p in prompts],
                   new_tokens=TURN_NEW_TOKENS, slots=TURN_SLOTS,
                   max_len=TURN_MAX_LEN, page=PAGE, init_s=init_s,
                   weights_gib=weights_gib,
                   served_weights="q/k-scaled" if cons["chaotic"]
                   else "as built",
                   **({"capacity_factor": cfg.moe.capacity_factor,
                       "experts": cfg.moe.n_experts,
                       "d_ff_expert": cfg.moe.d_ff} if n_moe else {}))
        emit("phase3g serve", **row)
        emit("phase3g copy serve", arch=arch,
             turns="zero_copy copy copy zero_copy", serves=turns[1:])
        first = firsts[0]
        if n_moe:       # the serve again at MOE_NO_DROP_CF: no drops
            _, eng, row, first = _dense_serve(no_drop, params, prompts,
                                              TURN_NEW_TOKENS, TURN_SLOTS,
                                              TURN_MAX_LEN)
            del eng
        rels, flips = _first_token_check(no_drop, params, prompts, first,
                                         gate=False)
        gated = [r for r, f in zip(rels, flips) if f == 0]
        emit("phase3g first-token", arch=arch,
             capacity_factor=(no_drop.moe.capacity_factor if n_moe
                              else None), first_token_rel=rels,
             first_token_flips=flips, prefill_rows=[
                 sum(len(q) == len(p) for q in prompts) for p in prompts],
             gated=len(gated),
             **{k: row[k] for k in ("decode_ms_per_step", "tokens_per_s",
                                    "ttft_ms_median", "peak_mem_gib")})
        assert gated and max(gated) < LOGIT_REL, (rels, flips)
        del params
        torch.cuda.empty_cache()
    return launches_by_arch


# ------------------------------------------------------------------ phase 3h

CROSS_ATTN_ARCHS = ("seamless-m4t-medium", "llama-3.2-vision-90b")
# llama-vision's cut: its first two periods of 5 (4 attn_mlp, then one
# xattn_mlp), every layer kind at its published width; all 100 layers are
# ~175 GB of bf16, past the card.
VISION_CUT = 10
CROSS_GATE = 1.0        # the reference draws every cross gate at 0


def _cross_arch_cfg(arch: str):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.n_image_tokens:
        cfg = dataclasses.replace(cfg, n_layers=VISION_CUT)
    return cfg


def phase_cross_archs() -> dict:
    """seamless-m4t-medium as get_config gives it (12 encoder and 12
    cross_mlp decoder layers) and llama-vision at full width on VISION_CUT
    layers (8 attn_mlp, 2 xattn_mlp over 4096 image tokens), bf16, random
    weights from SEED built on the card, every cross gate at CROSS_GATE,
    one at a time, the source ``_src_len`` rows long (seamless 3072, the
    reference's stubbed frame count; vision its image tokens): (a) decode
    against prefill, layer by layer and end to end where not chaotic, over
    random encoder input or image embeddings; (b) on the weights as built
    or, where chaotic, q/k-scaled, a zero-copy serve of phase 3's requests,
    then copy, copy and zero-copy in turns: figures and launches (the
    global decode, copy mode the per-slot one, once a self-attention layer
    a step; flash once a cross layer a decode step, the cross decode at Sq
    1, and once an encoder, self- and cross-attention layer a prefill
    call); (c) each request's first-token logits against a B=1 prefill,
    on the first zero-copy serve and the first copy serve. The engine, as
    the reference's, feeds a zero source. For llama-vision, (d) the first
    zero-copy serve's first tokens a layer at a time (``_vision_reading``).
    """
    from repro_torch.models import init_params
    launches_by_arch = {}
    for arch in CROSS_ATTN_ARCHS:
        cfg = _cross_arch_cfg(arch)
        resident = torch.cuda.memory_allocated()    # earlier phases'
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        params = init_params(cfg, gen, device="cuda")
        for blk in params["blocks"]:
            for layer in blk.values():
                if "xattn" in layer:
                    layer["xattn"]["gate"].fill_(CROSS_GATE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gib = sum(t.numel() * t.element_size()
                          for t in _leaves(params)) / 2**30
        params, cons = _consistency(cfg, params, CONSISTENCY_S[arch],
                                    phase="phase3h decode-vs-prefill")
        prompts = requests(cfg.vocab_size, np.random.default_rng(SEED))
        kinds = cfg.layer_kinds()
        n_self = sum(k != "xattn_mlp" for k in kinds)
        n_cross = sum(k in ("xattn_mlp", "cross_mlp") for k in kinds)
        per_prefill = cfg.n_enc_layers + n_self + n_cross
        turns, firsts, by_mode = _serve_turns(
            cfg, params, prompts, n_self,
            lambda r: r["launches"]["flash_attention_fwd"] == (
                n_cross * r["decode_steps"] + per_prefill * r["prefills"]),
            prefills={"copy": len(prompts), "zero_copy": 1},
            src_len=_src_len(cfg))
        launches_by_arch.update({f"{arch} {m}": n
                                 for m, n in by_mode.items()})
        for row, first in zip(turns[:2], firsts):
            row["first_token_rel"] = _first_token_check(
                cfg, params, prompts, first)[0]
        if cfg.n_image_tokens:
            _vision_reading(cfg, params, prompts, firsts[0],
                            turns[0]["first_token_rel"])
        for row in turns:       # the arch's own peak, past what stays
            row["arch_peak_gib"] = (row["peak_mem_gib"]
                                    - resident / 2**30)
        row = turns[0]
        row.update(arch=arch, dtype=cfg.activation_dtype,
                   n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
                   layer_kinds=sorted(set(kinds)), self_layers=n_self,
                   cross_layers=n_cross, flash_per_prefill=per_prefill,
                   src_len=_src_len(cfg), d_model=cfg.d_model,
                   heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", d_head=cfg.d_head,
                   d_ff=cfg.d_ff, act=cfg.act, vocab=cfg.vocab_size,
                   requests=len(prompts),
                   prompt_lens=[len(p) for p in prompts],
                   new_tokens=TURN_NEW_TOKENS, slots=TURN_SLOTS,
                   max_len=TURN_MAX_LEN, page=PAGE, init_s=init_s,
                   weights_gib=weights_gib,
                   resident_gib=resident / 2**30, cross_gate=CROSS_GATE,
                   served_weights="q/k-scaled" if cons["chaotic"]
                   else "as built")
        emit("phase3h serve", **row)
        emit("phase3h copy serve", arch=arch,
             turns="zero_copy copy copy zero_copy", serves=turns[1:])
        del params
        torch.cuda.empty_cache()
    return launches_by_arch


VISION_READING_N = 2    # the B=1 prefills held a layer at a time: the
                        # prompts whose first-token rel reads largest
# the fp32 run's logits: bucket against B=1. Set after the first reading,
# 4.2e-5 and 4.4e-5 where bf16 reads 0.040 and 0.032 (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §6): the gap is bf16's rounding at depth
VISION_FP32_REL = 1e-3


def _vision_reading(cfg, params, prompts, served, rels) -> dict:
    """The first-token reading of llama-vision's zero-copy serve, a layer
    at a time: the serve's (8, 512) bucket prefill (its padded rows and
    lengths, the zero image rows the engine feeds) and the B=1 prefills of
    the VISION_READING_N prompts whose first-token ``rels`` read largest,
    each run layer by layer without a cache, the residual stream read at
    each prompt's last token after the embedding and after every layer.
    ``layer_rel``: max |bucket - B=1| over max |B=1| there, a layer at a
    time; ``opens_at``: the first layer where it is not 0. Three runs:
    bf16 as served (flash's kernel), bf16 with flash's plain version, and
    fp32 (the same weights, each layer's cast up as it runs; activations
    fp32) with flash's plain version, since no flash kernel takes fp32 at
    D 128. A diagnostic beside the serve: the main path is the bf16 run.
    ``bucket_vs_served``: the bf16 bucket's logits against the serve's own
    first-token logits, which must be 0 (the replay is the served
    prefill); the fp32 run's logits must agree within VISION_FP32_REL."""
    from repro_torch.models.blocks import FwdCtx, apply_layer
    from repro_torch.models.layers import logits_fn, rmsnorm
    from repro_torch.models.model import _embed_in, layers
    from repro_torch.tree import tree_map
    lb = PAGE                   # the engine's bucket: a power of two
    while lb < max(len(p) for p in prompts):
        lb *= 2
    lb = min(lb, TURN_MAX_LEN)
    nb = len(prompts)
    toks = torch.zeros((nb, lb), dtype=torch.long, device="cuda")
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device="cuda")
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device="cuda")
    picks = sorted(range(nb), key=lambda i: -rels[i])[:VISION_READING_N]
    runs = {"bucket": (toks, lens)}
    runs.update({i: (toks[i:i + 1, :len(prompts[i])], None) for i in picks})
    last = {"bucket": lens.long() - 1}
    last.update({i: torch.tensor([len(prompts[i]) - 1], device="cuda")
                 for i in picks})

    def residuals(dt, plain: bool) -> tuple:
        c = dataclasses.replace(cfg, activation_dtype=str(dt).split(".")[-1])
        up = (lambda tree: tree_map(lambda t: t.float(), tree)
              if dt == torch.float32 else tree)
        at = {k: [] for k in runs}
        src = (nb, _src_len(cfg), cfg.d_model)
        with (_plain_flash() if plain else contextlib.nullcontext()), \
                torch.no_grad():
            emb = up(params["embed"])
            ctx = {k: FwdCtx(cfg=c, mode="prefill", seq_lengths=ln,
                             cross_x=torch.zeros((t.shape[0],) + src[1:],
                                                 dtype=dt, device="cuda"))
                   for k, (t, ln) in runs.items()}
            xs = {k: _embed_in(c, {"embed": emb}, t)
                  for k, (t, _) in runs.items()}
            kinds = ["embed"]
            rows_of = {k: torch.arange(t.shape[0], device="cuda")
                       for k, (t, _) in runs.items()}
            for k, x in xs.items():
                at[k].append(x[rows_of[k], last[k]].float())
            for kind, p in layers(c, params):
                p = up(p)
                for k in runs:
                    xs[k], _ = apply_layer(kind, p, xs[k], ctx[k], None)
                    at[k].append(xs[k][rows_of[k], last[k]].float())
                kinds.append(kind)
                del p
            logits = {}
            for k, x in xs.items():
                h = rmsnorm(x[rows_of[k], last[k]][:, None],
                            up(params["final_ln"]), cfg.norm_eps)
                logits[k] = logits_fn(emb, h, cfg.logit_softcap)[:, 0]
            del emb, xs
        torch.cuda.empty_cache()
        rows = {}
        for i in picks:
            rel = [_rel(a[i], b[0]) for a, b in zip(at["bucket"], at[i])]
            rows[str(len(prompts[i]))] = dict(
                layer_rel=rel,
                opens_at=next((n for n, r in enumerate(rel) if r > 0), None),
                logits_rel=_rel(logits["bucket"][i], logits[i][0]))
        return rows, kinds, logits["bucket"]

    t0 = time.perf_counter()
    bf16, kinds, bucket = residuals(torch.bfloat16, False)
    plain, _, _ = residuals(torch.bfloat16, True)
    fp32, _, _ = residuals(torch.float32, True)
    served_rel = []
    for i, p in enumerate(prompts):
        lg = [lg for n, tk, lg, _ in served
              if n == len(p) and p[n - len(tk):] == tk][-1]
        served_rel.append(_rel(bucket[i], lg))
    for rows in (bf16, plain, fp32):
        for n, row in rows.items():
            row["kind_at_open"] = (kinds[row["opens_at"]]
                                   if row["opens_at"] is not None else None)
    row = dict(arch=cfg.name, layers=cfg.n_layers, layer_kinds=kinds,
               bucket=[nb, lb], served_rels=rels,
               prompts=[len(prompts[i]) for i in picks],
               bucket_vs_served=served_rel, bf16=bf16, bf16_plain_flash=plain,
               fp32_plain_flash=fp32, seconds=time.perf_counter() - t0)
    emit("phase3h vision first-token layers", **row)
    assert max(served_rel) == 0, served_rel
    assert all(r["logits_rel"] <= VISION_FP32_REL for r in fp32.values()), \
        fp32
    return row


# ------------------------------------------------------------------ phase 3i

KIMI_ARCH = "kimi-k2-1t-a32b"
# kimi-k2's cut: its dense first layer (attention 64/8 at D 112, FFN 16384)
# and its first attn_moe layer (384 experts of d_ff 2048, top 8, a shared
# expert, the published capacity factor), with the whole 163840-row table
# and head: ~37 GiB of bf16. All 61 layers are ~2 TB.
KIMI_CUT = 2
# (a)'s capacity factor: E / K gives every expert as many slots as the
# batch has tokens, so no choice drops at any batch size. MOE_NO_DROP_CF
# does not suffice here: a decode batch of 2 tokens has C = 1 over 384
# experts, and two tokens that share an expert drop a choice.
KIMI_NO_DROP_CF = 384 / 8


def _kimi_cfg(capacity_factor=None):
    from repro_torch.configs import get_config
    cfg = get_config(KIMI_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=KIMI_CUT)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _kimi_prefill_cases() -> list:
    """Phase 3i's prefills as flash takes them (causal, 64/8, D 112): phase
    3's 8 requests padded to the engine's bucket, each request's length at
    B 1 (the first-token check), and (a)'s B 2 at S and S + 1 tokens."""
    cfg = _kimi_cfg()
    lens = [len(p) for p in requests(cfg.vocab_size,
                                     np.random.default_rng(SEED))]
    bucket = PAGE           # the engine's _bucket_len at max_len 1024
    while bucket < max(lens):
        bucket *= 2
    S = CONSISTENCY_S[KIMI_ARCH]
    shapes = ({(len(lens), bucket), (2, S), (2, S + 1)}
              | {(1, L) for L in lens})
    return [(B, L, L, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, True, None,
             None, 0) for B, L in sorted(shapes)]


def phase_kimi_arch() -> dict:
    """kimi-k2 at full width on KIMI_CUT layers (bf16, random weights from
    SEED built on the card): (a) decode against prefill, layer by layer
    and end to end where not chaotic, at KIMI_NO_DROP_CF; (b) on the
    weights as built or, where chaotic, q/k-scaled, one zero-copy serve of
    phase 3's requests at the published capacity: no staging copy, one
    global decode launch a layer a step, one flash launch a layer a
    prefill call that has no shared prefix, every one on the kernel
    ``kernel_for`` names at D 112, the dropped shares, ms a step, TTFT and
    peak GiB (and past what earlier phases keep resident); (c) each
    request's first-token logits against a B=1 prefill on a serve at
    MOE_NO_DROP_CF (where the prefills' capacities, a third of their
    tokens and more, drop nothing): a gate for every request whose last
    token took the same experts in both prefills (its logits read only
    its own MoE output), a reading where one choice flipped."""
    from repro_torch.kernels.flash_attention.ops import kernel_for
    from repro_torch.models import init_params
    cfg = _kimi_cfg()
    assert kernel_for(torch.bfloat16, cfg.d_head) == "wgmma"
    resident = torch.cuda.memory_allocated()        # earlier phases'
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    weights_gib = sum(t.numel() * t.element_size()
                      for t in _leaves(params)) / 2**30
    params, cons = _consistency(_kimi_cfg(KIMI_NO_DROP_CF), params,
                                CONSISTENCY_S[KIMI_ARCH],
                                phase="phase3i decode-vs-prefill")
    prompts = requests(cfg.vocab_size, np.random.default_rng(SEED))
    with _moe_drops() as rec:
        outs, eng, row, _ = _dense_serve(cfg, params, prompts,
                                         TURN_NEW_TOKENS, TURN_SLOTS,
                                         TURN_MAX_LEN)
    launches, steps = row["launches"], row["decode_steps"]
    assert row["staging_copies"] == 0, row
    assert launches["paged_attention_global"] == cfg.n_layers * steps, \
        launches
    flash = launches["flash_attention_fwd"]
    assert flash >= cfg.n_layers and flash % cfg.n_layers == 0, launches
    _other_launches_zero(launches, ("paged_attention_global",
                                    "flash_attention_fwd"))
    row["drops"] = drops = _drop_shares(rec)
    assert drops["decode"]["pairs"] == (
        steps * TURN_SLOTS * cfg.moe.experts_per_token), drops
    del eng
    kinds = cfg.layer_kinds()
    row.update(arch=KIMI_ARCH, dtype=cfg.activation_dtype,
               n_layers=cfg.n_layers, layer_kinds=list(kinds),
               d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
               d_head=cfg.d_head, flash_kernel=kernel_for(torch.bfloat16,
                                                          cfg.d_head),
               flash_prefill_calls=flash // cfg.n_layers, d_ff=cfg.d_ff,
               experts=cfg.moe.n_experts, top_k=cfg.moe.experts_per_token,
               d_ff_expert=cfg.moe.d_ff,
               shared_experts=cfg.moe.n_shared_experts,
               capacity_factor=cfg.moe.capacity_factor,
               vocab=cfg.vocab_size, requests=len(prompts),
               prompt_lens=[len(p) for p in prompts],
               new_tokens=TURN_NEW_TOKENS, slots=TURN_SLOTS,
               max_len=TURN_MAX_LEN, page=PAGE, init_s=init_s,
               init_peak_gib=init_peak, weights_gib=weights_gib,
               resident_gib=resident / 2**30,
               arch_peak_gib=row["peak_mem_gib"] - resident / 2**30,
               served_weights="q/k-scaled" if cons["chaotic"] else "as built")
    emit("phase3i serve", **row)
    # (c): no choice drops in the serve's prefill nor in a B=1 prefill
    no_drop = _kimi_cfg(MOE_NO_DROP_CF)
    _, eng, c_row, first = _dense_serve(no_drop, params, prompts,
                                        TURN_NEW_TOKENS, TURN_SLOTS,
                                        TURN_MAX_LEN)
    del eng
    rels, flips = _first_token_check(no_drop, params, prompts, first,
                                     gate=False, last_token=True)
    gated = [r for r, f in zip(rels, flips) if f == 0]
    emit("phase3i first-token", arch=KIMI_ARCH,
         capacity_factor=MOE_NO_DROP_CF, first_token_rel=rels,
         last_token_flips=flips, gated=len(gated),
         **{k: c_row[k] for k in ("decode_ms_per_step", "tokens_per_s",
                                  "ttft_ms_median", "peak_mem_gib")})
    assert gated and max(gated) < LOGIT_REL, (rels, flips)
    del params
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _device_us(ev) -> float:
    return float(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)))


def phase_profile(cfg, params, prompts, new_tokens, n_slots, max_len) -> None:
    """The phase-3 serve again, under torch.profiler: device busy time
    (the sum over device-side events only, kernels and copies, so no time
    is counted twice under the host op that launched it) against wall
    time, the decode kernels' device time and launches, and the top device
    kernels and host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, eng, _, wall = serve(cfg, params, "cuda", prompts, new_tokens,
                                n_slots, max_len, PAGE)
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_ms = sum(_device_us(e) for e in dev) / 1e3
    top = lambda evs, key: [(e.key[:60], e.count, round(key(e) / 1e3, 3))
                            for e in sorted(evs, key=key, reverse=True)[:12]]
    s = eng.stats()
    decode = [e for e in dev if DECODE_KERNELS in e.key]
    emit("phase3b profile", wall_s=wall, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / (wall * 1e3),
         device_launches=sum(e.count for e in dev),
         decode_device_ms=sum(_device_us(e) for e in decode) / 1e3,
         decode_device_launches=sum(e.count for e in decode),
         prefill_s=s["prefill_s"], decode_s=s["decode_s"],
         decode_steps=s["decode_steps"],
         top_device_ms=top(dev, _device_us),
         top_host_self_ms=top(host, lambda e: float(e.self_cpu_time_total)))


# ------------------------------------------------------------------ phase 4

CROSS_ARCHS = ("llama3.2-1b", "qwen2-7b", "llama3.2-3b", "gemma2-2b",
               "olmoe-1b-7b", "kimi-k2-1t-a32b") + RECURRENT_ARCHS \
    + CROSS_ATTN_ARCHS
SCHEDULED_ARCHS = ("llama3.2-1b", "qwen2-7b", "olmoe-1b-7b")


def phase_cross_check(arch: str, device: str = "cuda") -> None:
    """The smoke-reduced ``arch`` (fp32) served on ``device`` and on the CPU:
    zero-copy, then copy (an arch with sliding-window layers must refuse
    copy mode past its window of 8, and serves its rings in zero-copy), and
    for SCHEDULED_ARCHS the continuous and disaggregated kinds. Each must
    give the same tokens on both devices. An MoE arch's capacity, and so
    its drops, depend on the batch (copy mode prefills one prompt at its
    length), so its kinds' agreement with one another is recorded, not
    asserted: the reference has no such property either."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.serving.engine import ServingEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.models.params import RECURRENT_KINDS
    cfg = reduce_for_smoke(get_config(arch))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    params_dev = {k: _to(v, device) for k, v in params_cpu.items()}
    prompts = requests(cfg.vocab_size, np.random.default_rng(SEED), n=6,
                       system_len=20, lo=8, hi=40)
    kw = dict(max_tokens=8, n_slots=4, max_len=64, page=8)
    if cfg.n_image_tokens:          # the engine's default 16 would refuse
        kw["src_len"] = cfg.n_image_tokens
    windowed = "attn_mlp_local" in cfg.layer_kinds()
    moe = cfg.moe is not None
    modes = [("zero_copy", {})]
    if windowed:
        assert min(map(len, prompts)) > cfg.sliding_window
        try:
            ServingEngine(cfg, params_dev, n_slots=4, max_len=64,
                          page_size=8, offload_mode="copy", device=device)
        except NotImplementedError:
            pass
        else:
            raise AssertionError(f"{arch}: copy mode past the window served")
    else:
        modes += [("copy", dict(offload_mode="copy")),
                  ("zero_copy_unshared", dict(prefix_sharing=False))]
    runs = {}
    for mode, ekw in modes:
        reset_launch_counts()
        dev_outs, dev_eng, _, _ = serve(cfg, params_dev, device, prompts,
                                        **kw, **ekw)
        launches = launch_counts()
        s = check_serve(cfg, dev_eng, dev_outs, prompts, kw["max_tokens"])
        runs[mode] = dev_outs
        if mode == "zero_copy_unshared":
            break                   # held against copy mode below
        cpu_outs, cpu_eng, _, _ = serve(cfg, params_cpu, "cpu", prompts,
                                        **kw, **ekw)
        check_serve(cfg, cpu_eng, cpu_outs, prompts, kw["max_tokens"])
        if device == "cuda":
            used = (("paged_attention", "flash_attention_fwd")
                    if mode == "copy"
                    else ("paged_attention_global", "flash_attention_fwd")
                    + (("paged_attention",) if windowed else ()))
            if all(k in RECURRENT_KINDS for k in cfg.layer_kinds()):
                used = ()           # rwkv6: no attention layer
            assert all(launches[k] > 0 for k in used), launches
            assert all(n == 0 for k, n in launches.items()
                       if k not in used), launches
        same = dev_outs == cpu_outs
        emit("phase4 cuda-vs-cpu", arch=cfg.name, dtype=cfg.activation_dtype,
             device=device, offload_mode=mode, requests=len(prompts),
             identical_tokens=same, launches=launches,
             staging_copies=s["staging_copies"],
             shared_admissions=s["shared_admissions"],
             cow_page_copies=s["cow_page_copies"],
             **({"copy_raises": True} if windowed else {}))
        assert same, (f"{arch} {mode}: greedy tokens differ: {device} "
                      f"{dev_outs} vs cpu {cpu_outs}")
    if windowed:
        return
    same = runs["copy"] == runs["zero_copy_unshared"]
    emit("phase4 copy-vs-zero_copy", arch=cfg.name, device=device,
         prefix_sharing=False, identical_tokens=same, asserted=not moe)
    assert same or moe, (f"{arch}: copy {runs['copy']} vs zero_copy without "
                         f"prefix sharing {runs['zero_copy_unshared']}")
    if arch not in SCHEDULED_ARCHS:
        return
    # The scheduled kinds, the continuous engine over a pool of SMOKE_POOL
    # pages (it preempts): each must equal itself across devices and the
    # fixed engine's tokens. (A copy-mode transfer needs room for a second
    # copy of its sequence's pages, which SMOKE_POOL lacks here.)
    for kind in ("continuous", "disagg-share", "disagg-copy"):
        ekw = dict(kind=kind, pool_pages=SMOKE_POOL
                   if kind == "continuous" else None)
        reset_launch_counts()
        dev_outs, dev_eng, _, _ = serve(cfg, params_dev, device, prompts,
                                        **kw, **ekw)
        launches = launch_counts()
        s = check_serve(cfg, dev_eng, dev_outs, prompts, kw["max_tokens"])
        cpu_outs, cpu_eng, _, _ = serve(cfg, params_cpu, "cpu", prompts,
                                        **kw, **ekw)
        check_serve(cfg, cpu_eng, cpu_outs, prompts, kw["max_tokens"])
        if device == "cuda":
            assert launches["paged_attention_global"] > 0, launches
            _other_launches_zero(launches, ("paged_attention_global",))
        same = dev_outs == cpu_outs
        emit("phase4 cuda-vs-cpu", arch=cfg.name, dtype=cfg.activation_dtype,
             device=device, kind=kind, pool_pages=ekw["pool_pages"],
             requests=len(prompts), identical_tokens=same,
             equal_to_fixed=dev_outs == runs["zero_copy"],
             sched=s["sched"], transfer=s.get("transfer"),
             launches=launches, staging_copies=s["staging_copies"])
        assert same, (f"{arch} {kind}: greedy tokens differ: {device} "
                      f"{dev_outs} vs cpu {cpu_outs}")
        assert moe or dev_outs == runs["zero_copy"], (
            f"{arch} {kind}: {dev_outs} vs the fixed engine "
            f"{runs['zero_copy']}")
        if kind == "continuous":
            assert s["sched"]["preemptions"] > 0, s["sched"]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ------------------------------------------------------------------ phase 5

# The paper's sizes (repro/core/simulator/paper_targets.py SIZES) and sizes
# whose working sets are far past the H100's 50 MB L2.
PAPER_SIZES = {"gemm": 128, "gesummv": 512, "axpy": 32768, "heat3d": 64,
               "mergesort": 65536}
H100_SIZES = {"gemm": 8192, "gesummv": 16384, "axpy": 1 << 28, "heat3d": 512,
              "mergesort": 1 << 26}
# bf16 (M, K, N) whose rows of a are not 16-byte strides: the mma kernel.
GEMM_MMA_SHAPE = (8192, 8190, 8192)
HEAT3D_STEPS = 10
# (label, (Z, Y, X), offset in elements of the volume into its buffer):
# ragged tiles with 16-byte rows; rows that are not 16-byte strides in
# either dtype; the same as a contiguous view one element into a flat
# buffer, so its base is not 16-byte aligned either.
HEAT3D_SHAPES = [("h100_ragged", (509, 515, 520), 0),
                 ("h100_rows", (512, 512, 511), 0),
                 ("h100_offset", (512, 512, 511), 1)]
HEAT3D_DETERMINISM_STEPS = 50
GESUMMV_ALPHA, GESUMMV_BETA, AXPY_A = 1.5, -0.5, 2.5


def _paper_tol(name: str, dtype, k: int) -> tuple:
    """(atol, rtol) of |kernel - plain| <= atol + rtol * |plain|. axpy and
    heat3d round as their plain versions do: bit-equal. gemm and gesummv
    sum K products in fp32 in another order (and, for bf16 gemm, on the
    tensor cores). In fp32 the roundings of K partial sums, each up to
    about sqrt(K) in size, add up to about 2**-24 * K: 2**-20 * K leaves
    16x room. In bf16 the output may round the other way: one rounding
    step (2**-7 of it) plus half a step at its typical size, sqrt(K)."""
    if name in ("axpy", "heat3d_step"):
        return 0.0, 0.0
    if dtype == torch.float32:
        return 2.0 ** -20 * k, 1e-5
    return 2.0 ** -8 * k ** 0.5, 2.0 ** -7


def _paper_case(name: str, size, dtype, g, offset: int = 0) -> dict:
    """Inputs, entry point, kernel wrapper, plain version, library call,
    bytes and flops of one paper-kernel case, on the card. A gemm size is
    M = K = N, or an (M, K, N) tuple; a heat3d size is Z = Y = X, or a
    (Z, Y, X) tuple, and its volume starts ``offset`` elements into its
    buffer."""
    from repro_torch.kernels import axpy, gemm, gesummv, heat3d_step
    from repro_torch.kernels.axpy.ops import axpy_op
    from repro_torch.kernels.axpy.ref import axpy_ref
    from repro_torch.kernels.gemm.ops import kernel_for, matmul
    from repro_torch.kernels.gemm.ref import gemm_ref
    from repro_torch.kernels.gesummv.ops import gesummv_op
    from repro_torch.kernels.gesummv.ref import gesummv_ref
    from repro_torch.kernels.heat3d.ops import heat3d
    from repro_torch.kernels.heat3d.ops import kernel_for as heat3d_kernel_for
    from repro_torch.kernels.heat3d.ref import C0, C1, heat3d_step_ref
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    it = torch.tensor([], dtype=dtype).element_size()
    if name == "gemm":
        m, k, n = (size,) * 3 if isinstance(size, int) else size
        a, b = mk(m, k), mk(k, n)
        aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
        return dict(k=k, entry=lambda: matmul(a, b), launches=1,
                    kind=kernel_for(dtype, m, n, k, aligned),
                    kernel=lambda: gemm(a, b), plain=lambda: gemm_ref(a, b),
                    library=lambda: torch.matmul(a, b),
                    nbytes=(m * k + k * n + m * n) * it, flops=2 * m * n * k)
    if name == "gesummv":
        A, B, x = mk(size, size), mk(size, size), mk(size)
        args = (GESUMMV_ALPHA, GESUMMV_BETA, A, B, x)
        return dict(k=size, entry=lambda: gesummv_op(*args), launches=1,
                    kernel=lambda: gesummv(*args),
                    plain=lambda: gesummv_ref(*args),
                    two_mv=lambda: (torch.mv(A, x), torch.mv(B, x)),
                    nbytes=(2 * size * size + 2 * size) * it,
                    flops=4 * size * size + 3 * size)
    if name == "axpy":
        x, y = mk(size), mk(size)
        return dict(k=1, entry=lambda: axpy_op(AXPY_A, x, y), launches=1,
                    kernel=lambda: axpy(AXPY_A, x, y),
                    plain=lambda: axpy_ref(AXPY_A, x, y),
                    library=lambda: torch.add(y, x, alpha=AXPY_A),
                    nbytes=3 * size * it, flops=2 * size)
    shape = (size,) * 3 if isinstance(size, int) else tuple(size)
    numel = shape[0] * shape[1] * shape[2]
    u = mk(numel + offset)[offset:].view(shape)
    w = torch.zeros(1, 1, 3, 3, 3, device="cuda", dtype=dtype)
    w[0, 0, 1, 1, 1] = C0
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w[(0, 0) + idx] = C1
    u5 = u[None, None]

    def plain_steps():
        v = u
        for _ in range(HEAT3D_STEPS):
            v = heat3d_step_ref(v)
        return v
    kind = heat3d_kernel_for(dtype, shape[2], u.data_ptr() % 16 == 0)
    dt = "float" if dtype == torch.float32 else "__nv_bfloat16"
    return dict(k=1, entry=lambda: heat3d(u, steps=HEAT3D_STEPS),
                launches=HEAT3D_STEPS, entry_plain=plain_steps,
                kind=f"heat3d_ring_kernel<{dt}, {kind}>",
                template_args=f"<{dt}, {str(kind == 'rows16').lower()}>",
                kernel=lambda: heat3d_step(u), plain=lambda: heat3d_step_ref(u),
                library=lambda: torch.nn.functional.conv3d(u5, w),
                nbytes=2 * numel * it,
                flops=8 * (shape[0] - 2) * (shape[1] - 2) * (shape[2] - 2))


def phase_paper_kernels() -> dict:
    """Phase 5: each paper kernel's entry point on the card, counted, and
    held against its plain version; then kernel, plain and library timed.
    Counts are reset just before each entry-point call and read just after
    it; the comparison and timing launches come after that read."""
    from repro_torch.kernels import gemm, launch_counts, reset_launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32 here
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    names = {"gemm": "gemm", "gesummv": "gesummv", "axpy": "axpy",
             "heat3d": "heat3d_step"}
    cases = [(label, short, sizes[short], dtype, 0)
             for label, sizes in (("paper", PAPER_SIZES), ("h100", H100_SIZES))
             for short in names for dtype in (torch.float32, torch.bfloat16)]
    cases.append(("h100_mma", "gemm", GEMM_MMA_SHAPE, torch.bfloat16, 0))
    cases += [(label, "heat3d", shape, dtype, offset)
              for label, shape, offset in HEAT3D_SHAPES
              for dtype in (torch.float32, torch.bfloat16)]
    res = {}
    for label, short, size, dtype, offset in cases:
        name = names[short]
        case = _paper_case(short, size, dtype, g, offset)
        torch.cuda.synchronize()
        reset_launch_counts()
        out = case["entry"]()
        torch.cuda.synchronize()
        launches = launch_counts()
        wgmma_launches = gemm.wgmma_launches
        assert launches[name] == case["launches"], launches
        if short == "gemm":
            assert wgmma_launches == (case["kind"] == "wgmma"), \
                (case["kind"], wgmma_launches)
            if label == "h100" and dtype == torch.bfloat16:
                assert case["kind"] == "wgmma", case["kind"]
            if label == "h100_mma":
                assert case["kind"] == "mma", case["kind"]
        assert all(n == 0 for k, n in launches.items() if k != name), \
            launches
        ref = case.get("entry_plain", case["plain"])()
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert torch.isfinite(out).all(), f"{name}: non-finite"
        atol, rtol = _paper_tol(name, dtype, case["k"])
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        bad = int((diff > atol + rtol * ref.float().abs()).sum())
        del diff, out, ref
        assert bad == 0, (f"{name} {label} {dtype}: {bad} elements "
                          f"off, max abs err {err}")
        # fp32 gemm at the H100 size takes ~25 ms a call
        slow = label == "h100" and short == "gemm" and \
            dtype == torch.float32
        iters = 3 if slow else 20
        warm = 1 if slow else 3
        ms = cuda_ms(case["kernel"], warm, iters)
        plain = cuda_ms(case["plain"], 1, min(iters, 5))
        lib = (cuda_ms(case["library"], warm, iters)
               if "library" in case else None)
        two_mv = (cuda_ms(case["two_mv"], warm, iters)
                  if "two_mv" in case else None)
        bound, by = _bound(case["nbytes"], case["flops"], dtype)
        row = dict(sizes=label, size=size, dtype=str(dtype),
                   launches=launches[name],
                   max_abs_err=err, atol=atol, rtol=rtol, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bound,
                   bound_by=by, bytes=case["nbytes"],
                   flops=case["flops"])
        if two_mv is not None:
            row["two_mv_ms"] = two_mv
        if short == "gemm":
            row["kernel"] = case["kind"]
            row["wgmma_launches"] = wgmma_launches
        if short in ("gemm", "axpy"):
            # without the host's per-call work between the events
            row["ms_back_to_back"] = back_to_back_ms(
                case["kernel"], warm, iters)
            row["library_ms_back_to_back"] = back_to_back_ms(
                case["library"], warm, iters)
        if short == "heat3d" and dtype == torch.float32:
            # the yardstick computes the same stencil on the interior
            conv = case["library"]()[0, 0]
            row["library_max_abs_err"] = (
                conv - case["plain"]()[1:-1, 1:-1, 1:-1]).abs().max().item()
            assert row["library_max_abs_err"] <= 1e-5, row
        if short == "heat3d":
            dev, dev_n, kernels = _kernel_device_ms(case["kernel"],
                                                    "heat3d_ring_kernel")
            # the profiler names the instantiation the wrapper launched
            assert all(case["template_args"] in k for k in kernels), \
                (case["kind"], kernels)
            row.update(kernel=case["kind"], offset=offset, device_ms=dev,
                       device_launches_recorded=dev_n,
                       device_kernels=kernels,
                       ms_back_to_back=back_to_back_ms(case["kernel"],
                                                       warm, iters),
                       steps=HEAT3D_STEPS,
                       ms_all_steps=cuda_ms(case["entry"], 1, 3))
        emit(f"phase5 paper {name}", **row)
        res[(name, label, dtype)] = row
        del case
        torch.cuda.empty_cache()
    _heat3d_determinism(g)
    return res


def _heat3d_determinism(g) -> None:
    """50 steps at 512^3 run twice must agree bit for bit (a race in the
    ring or at its barrier would show as a difference), and with the plain
    version's 50 steps."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.heat3d.ops import heat3d
    from repro_torch.kernels.heat3d.ref import heat3d_step_ref
    n, steps = H100_SIZES["heat3d"], HEAT3D_DETERMINISM_STEPS
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.randn(n, n, n, generator=g, device="cuda").to(dtype)
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            reset_launch_counts()
            runs.append(heat3d(u, steps=steps))
            torch.cuda.synchronize()
            assert launch_counts()["heat3d_step"] == steps, launch_counts()
        ref = u
        for _ in range(steps):
            ref = heat3d_step_ref(ref)
        identical = torch.equal(runs[0], runs[1])
        err = (runs[0].float() - ref.float()).abs().max().item()
        emit("phase5 heat3d determinism", size=n, dtype=str(dtype),
             steps=steps, launches=steps, identical=identical,
             max_abs_err=err)
        assert identical and err == 0.0, (dtype, identical, err)
        del u, runs, ref
        torch.cuda.empty_cache()


SORT_BLOCK = 1024
SORT_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
# One compare-exchange counted as one operation at the fp32 rate outside the
# tensor cores: a generous floor, far under the bytes bound at every size.
SORT_OPS_PER_S = PEAK_FLOPS[torch.float32]
SORT_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.int32: torch.int32}


def _sort_input(n: int, dtype, g, nan: bool = False):
    """Normals (x1000, rounded, for int32); a quarter of the places tied to
    64 integer values; one in 16 from -0.0, +0.0, -inf, +inf (int32: 0,
    -1 and the two extremes); with ``nan``, one NaN at n/3."""
    dev = "cuda"
    x = torch.randn(n, generator=g, device=dev)
    if dtype == torch.int32:
        x = (x * 1000).round()
    ties = torch.rand(n, generator=g, device=dev) < 0.25
    x = torch.where(ties, torch.randint(0, 64, (n,), generator=g,
                                        device=dev).float(), x).to(dtype)
    pool = (torch.tensor([0, -1, -2 ** 31, 2 ** 31 - 1], dtype=dtype,
                         device=dev) if dtype == torch.int32 else
            torch.tensor([-0.0, 0.0, -float("inf"), float("inf")],
                         dtype=dtype, device=dev))
    at = torch.rand(n, generator=g, device=dev) < 1 / 16
    pick = torch.randint(0, 4, (n,), generator=g, device=dev)
    x = torch.where(at, pool[pick], x)
    if nan:
        x[n // 3] = float("nan")
    return x.contiguous()


def _sort_case(label: str, n: int, dtype, g, nan: bool) -> dict:
    """One mergesort case: the entry point counted and held bit for bit
    against its plain version (and as values against torch.sort, without
    NaN); then, without NaN, every time and bound; with a NaN at 2^26, the
    entry point's time (its tiles and passes with the NaN take the exact
    compare)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.mergesort.ops import (R, _sort_tiles, block_sort,
                                                   launch_counts_of,
                                                   merge_stage, merge_tile,
                                                   mergesort, plan, tile_of)
    from repro_torch.kernels.mergesort.ref import (block_sort_ref,
                                                   mergesort_ref, stages)
    x = _sort_input(n, dtype, g, nan)
    keep = x.clone()
    torch.cuda.synchronize()
    reset_launch_counts()
    out = mergesort(x, block=SORT_BLOCK)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = launch_counts_of(n, SORT_BLOCK)
    assert all(launches[k] == want.get(k, 0) for k in launches), \
        (launches, want)
    big = n >= 1 << 20
    ref = None

    def plain():
        nonlocal ref
        ref = mergesort_ref(x, SORT_BLOCK)
    plain_ms = cuda_ms(plain, 0, 1) if big else cuda_ms(plain, 1, 3)
    bits = SORT_BITS[dtype]
    bit_equal = torch.equal(out.view(bits), ref.view(bits))
    assert bit_equal, f"mergesort {label} {dtype} nan={nan}: not bit-equal"
    assert torch.equal(x.view(bits), keep.view(bits)), "input written"
    diff = (out.double() - ref.double()).abs()
    err = torch.nan_to_num(diff, nan=0.0).max().item()
    it = x.element_size()
    one_pass = 2 * n * it / HBM_BYTES_PER_S * 1e3
    total = sum(want.values())
    tile = tile_of(n)
    iters = 10 if big else 20
    row = dict(n=n, dtype=str(dtype), block=SORT_BLOCK, nan=nan,
               launches={k: launches[k] for k in want}, bit_equal=bit_equal,
               max_abs_err=err, plain_ms=plain_ms, tile=tile, r=R,
               passes=want["merge_stage"], entry_launches=total,
               entry_bound_ms=total * one_pass, one_pass_ms=one_pass)
    if not nan:
        row["equals_torch_sort"] = torch.equal(out, torch.sort(x).values)
        assert row["equals_torch_sort"], f"mergesort {label} {dtype}"
    del diff, out, ref
    torch.cuda.empty_cache()
    if nan:
        if big:
            row["entry_ms"] = cuda_ms(
                lambda: mergesort(x, block=SORT_BLOCK), 2, iters)
        return row
    row.update(
        ms=cuda_ms(lambda: block_sort(x, block=SORT_BLOCK), 3, iters),
        block_sort_plain_ms=cuda_ms(lambda: block_sort_ref(x, SORT_BLOCK),
                                    *((0, 1) if big else (1, 5))),
        library_ms=cuda_ms(lambda: torch.sort(
            x.view(-1, SORT_BLOCK), dim=1).values, 3, iters),
        entry_ms=cuda_ms(lambda: mergesort(x, block=SORT_BLOCK), 2, iters),
        sort_ms=cuda_ms(lambda: torch.sort(x).values, 3, iters))
    # block_sort: each element read and written once; n/2 compare-exchanges
    # in each of the log2(B)(log2(B)+1)/2 stages of a block of B
    stages_b = sum(range(1, SORT_BLOCK.bit_length()))
    ops_ms = n // 2 * stages_b / SORT_OPS_PER_S * 1e3
    row["bound_ms"], row["bound_by"] = max((one_pass, "bytes"),
                                           (ops_ms, "operations"))
    # the launches of the full sort alone, in place on a copy: its block
    # sort (every level up to the tile), the last level's first pass (the
    # flip and R stages) and second pass where it has one, and its tile
    y = x.clone()
    passes = [s for s in plan(n, SORT_BLOCK, tile, True) if s[0] ==
              "merge_stage" and s[1] == n]
    row["ladder_block_sort_ms"] = cuda_ms(lambda: _sort_tiles(
        x, y, SORT_BLOCK, tile, min(tile, n)), 3, iters)
    for name, step in zip(("merge_stage", "merge_stage_noflip"), passes):
        _, k, j_hi, j_lo, flip = step
        row[f"{name}_ms"] = cuda_ms(lambda: merge_stage(
            y, k=k, j_hi=j_hi, j_lo=j_lo, block=SORT_BLOCK, flip=flip), 3,
            iters)
        row[f"{name}_stages"] = (j_hi // j_lo).bit_length()
        row[f"{name}_plain_ms"] = cuda_ms(lambda: stages(
            y, k, SORT_BLOCK, j_hi, j_lo, flip), 1, 3)
    row.update(
        merge_tile_ms=cuda_ms(lambda: merge_tile(
            y, k=n, block=SORT_BLOCK, tile=tile), 3, iters),
        merge_tile_plain_ms=cuda_ms(lambda: stages(
            y, n, SORT_BLOCK, tile // 2), 1, 3))
    del y, x, keep
    torch.cuda.empty_cache()
    return row


def phase_mergesort() -> dict:
    """Phase 5, mergesort: the entry point at the paper's size and at 2^26
    in fp32, bf16 and int32, and with a NaN in fp32 and bf16 at the paper's
    size and in fp32 at 2^26. Counts are reset just before each entry-point call and read just
    after it; the comparison and timing launches come after that read."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    res = {}
    cases = [(label, sizes["mergesort"], dtype, False)
             for label, sizes in (("paper", PAPER_SIZES), ("h100", H100_SIZES))
             for dtype in SORT_DTYPES]
    cases += [("paper", PAPER_SIZES["mergesort"], dtype, True)
              for dtype in (torch.float32, torch.bfloat16)]
    cases.append(("h100", H100_SIZES["mergesort"], torch.float32, True))
    for label, n, dtype, nan in cases:
        row = _sort_case(label, n, dtype, g, nan)
        emit("phase5 paper mergesort", sizes=label, **row)
        res[(label, dtype, nan)] = row
    return res


# ------------------------------------------------------------------ main

def _sort_rows(sort: dict) -> list:
    """The kernels-line rows of block_sort and the merge kernels: fp32 at
    2^26 as the main row, launches summed over phase 5's mergesort calls."""
    main_row = sort[("h100", torch.float32, False)]
    rows = list(sort.values())
    cases = [{k: r[k] for k in ("n", "dtype", "nan", "launches", "tile", "r",
                                 "passes", "max_abs_err", "ms", "plain_ms",
                                 "block_sort_plain_ms", "library_ms",
                                 "entry_ms", "sort_ms", "bound_ms",
                                 "entry_bound_ms", "ladder_block_sort_ms",
                                 "merge_stage_ms", "merge_stage_noflip_ms",
                                 "merge_tile_ms") if k in r}
             for r in rows]
    out = [{
        "name": "block_sort", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mergesort.cu",
        "replaces": "src/repro/kernels/mergesort/kernel.py:46",
        "launches": sum(r["launches"]["block_sort"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["block_sort_plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "n": main_row["n"],
        "dtype": main_row["dtype"],
        "mergesort_ms": main_row["entry_ms"],
        "mergesort_plain_ms": main_row["plain_ms"],
        "mergesort_bound_ms": main_row["entry_bound_ms"],
        "torch_sort_ms": main_row["sort_ms"], "cases": cases}]
    for name in ("merge_stage", "merge_tile"):
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mergesort.cu",
            "replaces": "src/repro/kernels/mergesort/ops.py:16",
            "launches": sum(r["launches"][name] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row[f"{name}_ms"],
            "plain_ms": main_row[f"{name}_plain_ms"],
            "bound_ms": main_row["one_pass_ms"], "bound_by": "bytes",
            "library_ms": None, "n": main_row["n"],
            "dtype": main_row["dtype"]})
    return out


# ------------------------------------------------------------------ phase 6

TRAIN_ARCH = "llama3.2-1b"
TRAIN_B, TRAIN_S = 4, 2048
TRAIN_STEPS = 6
LSE_TOL = 1e-3          # fp32 sums in another order, |lse| <= ~10
# kernel path against plain-attention path, a limit for each weight set:
# ~4x the largest sound reading on the chaotic weights as built (the
# control, 4.6e-4; the kernel path 1.4e-4), ~25x the kernel path's on the
# scaled ones (4.1e-6; the control 1.6e-7)
TRAIN_LOSS_REL = {"built": 2e-3, "scaled": 1e-4}
TRAIN_GRAD_REL = 5e-2   # a leaf's max |d| / max |g|, phase 3e's limit
TRAIN_DQKV_REL = 2e-2   # the flash backward fed by the kernel or the plain
                        # forward: the residuals differ by bf16 roundings
LSE_FAULT = 0.1         # the planted fault: every lse off by 0.1, so the
                        # backward's P is off by ~10%


def _plain_flash():
    """The port's attention with its flash forward replaced by the plain
    version (lse included), to hold the kernel path against; a comparison
    here, never a path the port takes."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import attention as attn
    return mock.patch.object(attn, "flash_attention_fwd", flash_attention_ref)


def _train_flash() -> dict:
    """(a) The flash kernel at the training shape (llama3.2-1b's attention
    over B 4 x 2048, bf16, causal): out and lse against the plain version;
    the forward's time with and without lse, the plain version's and
    SDPA's (K/V repeated to Hq); dq, dk, dv of the autograd
    Function with the kernel's forward against the plain forward's (one
    backward, plain PyTorch); the backward's time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import attention as attn
    cfg = get_config(TRAIN_ARCH)
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    q, k, v = _flash_inputs(g, torch.bfloat16, TRAIN_B, TRAIN_S, TRAIN_S,
                            cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    kw = dict(causal=True, window=None, softcap=None, q_offset=0)
    chunks = dict(q_chunk=cfg.flash_q_chunk, kv_chunk=cfg.flash_kv_chunk)
    check = _flash_check(q, k, v, kw)
    out, lse = flash_attention_fwd(q, k, v, **kw, return_lse=True)
    ref, ref_lse = flash_attention_ref(q, k, v, **kw, **chunks,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, flash_attention_fwd(q, k, v, **kw)), \
        "flash: out differs with and without lse"
    lse_err = (lse - ref_lse).abs().max().item()
    assert torch.isfinite(lse).all() and lse_err <= LSE_TOL, \
        f"flash lse: err {lse_err} > {LSE_TOL}"
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw))
    ms_lse = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw,
                                                 return_lse=True))
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw, **chunks),
                       warmup=1, iters=3)
    G = cfg.n_heads // cfg.n_kv_heads
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    del qt, kt, vt
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)

    def grads():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = attn.flash_attention(*leaves, **kw, **chunks)
        return torch.autograd.grad(o, leaves, do)

    ours = grads()
    with _plain_flash():
        plain = grads()
    torch.cuda.synchronize()
    rel = {n: ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
           for n, a, b in zip(("dq", "dk", "dv"), ours, plain)}
    assert all(r <= TRAIN_DQKV_REL for r in rel.values()), \
        f"flash backward, kernel against plain forward: {rel}"
    bwd_ms = cuda_ms(lambda: attn.flash_attention_bwd(
        q, k, v, out, lse, do, **kw, **chunks), warmup=1, iters=5)
    fl = _flash_flops(TRAIN_B, TRAIN_S, TRAIN_S, cfg.n_heads, cfg.d_head,
                      True, None, 0)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    bound, by = _bound(nbytes + lse.numel() * 4, fl, q.dtype)
    row = dict(shape=[TRAIN_B, TRAIN_S, cfg.n_heads, cfg.n_kv_heads,
                      cfg.d_head], **check, lse_err=lse_err, lse_tol=LSE_TOL,
               ms=ms, ms_lse=ms_lse, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound, bound_by=by,
               grad_rel_kernel_vs_plain_fwd=rel, grad_rel_tol=TRAIN_DQKV_REL,
               plain_bwd_ms=bwd_ms)
    emit("phase6 train flash", **row)
    return row


def _train_batch(cfg, g) -> dict:
    mk = lambda: torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                               generator=g, device="cuda")
    return {"tokens": mk(), "labels": mk()}


@contextlib.contextmanager
def _lse_fault():
    """The kernel path with every row's lse off by LSE_FAULT: a planted
    fault the gradient gate must catch (the forward's output is exact)."""
    from repro_torch.kernels import flash_attention_fwd
    from repro_torch.models import attention as attn

    def faulty(*a, return_lse=False, **kw):
        res = flash_attention_fwd(*a, return_lse=return_lse, **kw)
        return (res[0], res[1] + LSE_FAULT) if return_lse else res

    with mock.patch.object(attn, "flash_attention_fwd", faulty):
        yield


def _grad_rel(grads, ref) -> list:
    """Each leaf's max |d| over the reference leaf's max |g|."""
    from repro_torch.tree import leaves
    return [((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp(min=1e-30)).item()
            for a, b in zip(leaves(grads), leaves(ref))]


def _train_grads(cfg, params, batch) -> dict:
    """(b) One full-width bf16 loss and backward on the kernel path and on
    the plain-attention path, first on the weights as built, then on the
    same weights with every wq and wk x 0.1 (phase 3e's scaling, under
    which attention is not chaotic). Two readings on each, against the
    plain path: the control, the plain path at half the KV chunk (another
    summation order of the same function: what a sound path reads), and
    the planted fault, the kernel path with its lse off by LSE_FAULT
    (what a faulty backward reads). Gates: the loss within TRAIN_LOSS_REL
    on each; each leaf's gradient within TRAIN_GRAD_REL of its largest
    value on the scaled weights, and on the weights as built too where
    the control reads below CHAOTIC (otherwise the init's chaos, a
    reading); the planted fault past TRAIN_GRAD_REL on the scaled
    weights; two flash launches a layer on the kernel path."""
    from repro_torch.kernels import flash_attention_fwd, reset_launch_counts
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.tree import leaves
    row = dict(loss_tol=TRAIN_LOSS_REL, grad_tol=TRAIN_GRAD_REL,
               lse_fault=LSE_FAULT)
    half = dataclasses.replace(cfg, flash_kv_chunk=cfg.flash_kv_chunk // 2)
    rel = lambda a, b: abs(a.item() - b.item()) / abs(b.item())
    for name, p in (("built", params), ("scaled", _qk_scaled(params))):
        reset_launch_counts()
        loss, grads = loss_and_grads(cfg, p, batch)
        torch.cuda.synchronize()
        launches = flash_attention_fwd.launches
        assert launches == 2 * cfg.n_layers, launches
        assert all(torch.isfinite(t).all().item() for t in leaves(grads))
        with _plain_flash():
            ploss, pgrads = loss_and_grads(cfg, p, batch)
            rels = _grad_rel(grads, pgrads)
            del grads
            closs, cgrads = loss_and_grads(half, p, batch)
            control = _grad_rel(cgrads, pgrads)
            del cgrads
        with _lse_fault():
            floss, fgrads = loss_and_grads(cfg, p, batch)
            fault = _grad_rel(fgrads, pgrads)
            del fgrads
        del pgrads
        row[name] = dict(loss=loss.item(), plain_loss=ploss.item(),
                         loss_rel=rel(loss, ploss),
                         grad_rel_max=max(rels),
                         grad_rel_median=statistics.median(rels),
                         control_loss_rel=rel(closs, ploss),
                         control_rel_max=max(control),
                         control_rel_median=statistics.median(control),
                         fault_loss_rel=rel(floss, ploss),
                         fault_rel_max=max(fault),
                         fault_rel_median=statistics.median(fault),
                         leaves=len(rels), flash_launches=launches)
    row["chaotic"] = row["built"]["control_rel_max"] >= CHAOTIC
    emit("phase6 train grads", **row)
    for name in ("built", "scaled"):
        assert row[name]["loss_rel"] <= TRAIN_LOSS_REL[name], row
    assert row["scaled"]["grad_rel_max"] <= TRAIN_GRAD_REL, row
    assert row["scaled"]["fault_rel_max"] > TRAIN_GRAD_REL, row
    assert row["chaotic"] or row["built"]["grad_rel_max"] <= TRAIN_GRAD_REL, \
        row
    return row


def _bare_steps(cfg, params, batch, n: int = 3,
                data_thread: bool = False) -> dict:
    """ms of make_train_step's step on one batch, outside the launcher,
    after one step of warm-up; with ``data_thread``, while the launcher's
    data pipeline (its prefetch thread) draws batches beside it."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    step = make_train_step(cfg, TrainConfig(total_steps=n + 1,
                                            warmup_steps=1))
    opt = init_opt_state(params)
    data = (make_pipeline(cfg.vocab_size, TRAIN_B, TRAIN_S, SEED)
            if data_thread else None)
    times = []
    try:
        for _ in range(n + 1):
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            loss = m["loss"].item()
            times.append((time.perf_counter() - t0) * 1e3)
            assert np.isfinite(loss), loss
    finally:
        if data is not None:
            data.close()
    return dict(ms=times[1:], ms_median=statistics.median(times[1:]))


def _data_batch_ms(cfg, n: int = 2) -> list:
    """ms for the launcher's synthetic data to draw one (TRAIN_B, TRAIN_S)
    batch, on this thread with nothing beside it."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    it = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_B, TRAIN_S,
                                SEED)).batches()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        next(it)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _run_launcher(argv) -> str:
    """``repro_torch.launch.train.main(argv)``, its output echoed and
    returned."""
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    assert rc == 0, rc
    return out


def _launcher_full_width() -> dict:
    """(c) ``python -m repro_torch.launch.train`` at full width for
    TRAIN_STEPS steps (its synthetic data, B 4 x 2048): every loss
    finite; ms a step (the launcher's own, the step alone: median of the
    steps after the first), its wall time a step (the launcher's "[train]
    done" time over the steps: the first step and the waits for data
    included), tokens/s on each, peak GiB and flash launches a step,
    counted from 0 just before the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_fwd, reset_launch_counts
    layers = get_config(TRAIN_ARCH).n_layers
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    out = _run_launcher(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                         "--log-every", "1"])
    launches = flash_attention_fwd.launches
    wgmma = flash_attention_fwd.wgmma_launches
    steps = [ln.split() for ln in out.splitlines() if ln.startswith("step ")]
    losses = [float(s[3]) for s in steps]
    ms = [float(s[-1].removesuffix("ms")) for s in steps]
    done = [ln.split() for ln in out.splitlines()
            if ln.startswith("[train] done")]
    assert len(steps) == TRAIN_STEPS and all(np.isfinite(losses)), out
    assert launches == wgmma == 2 * layers * TRAIN_STEPS, launches
    med = statistics.median(ms[1:])
    # "[train] done <n> steps in <s>s; stragglers=<k>"
    wall = float(done[-1][5].removesuffix("s;")) / TRAIN_STEPS * 1e3
    row = dict(losses=losses, ms=ms, ms_a_step=med,
               tokens_per_s=TRAIN_B * TRAIN_S / (med / 1e3),
               wall_ms_a_step=wall,
               tokens_per_s_wall=TRAIN_B * TRAIN_S / (wall / 1e3),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               resident_gib=base / 2 ** 30,
               flash_launches=launches,
               flash_launches_a_step=launches / TRAIN_STEPS)
    emit("phase6 train launcher", **row)
    return row


def _launcher_restart() -> dict:
    """(d) The restart recipe at smoke size on the card: a failure injected
    at step 7 restores the checkpoint of step 5 and the run ends."""
    import tempfile
    from repro_torch.kernels import flash_attention_fwd, reset_launch_counts
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix=".train_ck_", dir=HERE) as ck:
        out = _run_launcher(["--arch", TRAIN_ARCH, "--smoke", "--steps", "12",
                             "--batch", "2", "--seq", "32", "--ckpt-dir", ck,
                             "--ckpt-every", "5", "--inject-failure-at", "7",
                             "--log-every", "100"])
    lines = ("injected worker failure at step 7", "restored step 5",
             "[train] done")
    row = {ln: ln in out for ln in lines}
    row["flash_launches"] = flash_attention_fwd.launches
    emit("phase6 train restart", **row)
    assert all(row[ln] for ln in lines) and row["flash_launches"] > 0, row
    return row


def phase_train() -> dict:
    """6. Training at full width (llama3.2-1b as get_config gives it: 16
    layers, bf16, remat "full"): (a) flash's lse and the backward it
    feeds, (b) one loss and backward, kernel against plain attention, then
    the bare step's time, (c) the train launcher for TRAIN_STEPS steps,
    (d) its restart recipe at smoke size. Nothing here runs the garbage
    collector: memory a step left in a reference cycle would show in
    ``resident_gib`` and the peak."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    res = {"flash": _train_flash()}
    cfg = get_config(TRAIN_ARCH)
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    params = init_params(cfg, g, "cuda")
    batch = _train_batch(cfg, g)
    res["grads"] = _train_grads(cfg, params, batch)
    bare = _bare_steps(cfg, params, batch)
    threaded = _data_batch_ms(cfg), _bare_steps(cfg, params, batch,
                                                data_thread=True)
    del params, batch
    res["bare"] = dict(bare_ms=bare["ms"], bare_ms_median=bare["ms_median"],
                       data_batch_ms=threaded[0],
                       bare_ms_data_thread=threaded[1]["ms"],
                       bare_ms_data_thread_median=threaded[1]["ms_median"])
    emit("phase6 train bare step", **res["bare"])
    res["launcher"] = _launcher_full_width()
    res["restart"] = _launcher_restart()
    return res


# ------------------------------------------------------------------ phase 7

MESH_ARCH = "llama3.2-1b"
MESH_WORLD = 4
MESH_MAX_LEN = 524288    # long_500k's seq_len (repro/configs/__init__.py:37)
MESH_PAGE = 16
MESH_NEW = 32
MESH_PROMPT_LENS = (256, 731, 2048)
MESH_LAYER_S = 2000      # the layer-by-layer check's prompt
MESH_FILL_GAP = 64       # the fill's length: MESH_MAX_LEN - 64
MESH_FILL_STEPS = 3
DECODE_LSE_TOL = 1e-3    # fp32 sums in another order, |lse| <= ~20
MESH_RANKS_S = 600       # the ranks' deadline (they take ~40-60 s)


def _weights_sum(params) -> float:
    """A fingerprint of the weights: every leaf's sum in fp64."""
    return float(sum(torch.sum(t, dtype=torch.float64).item()
                     for t in _leaves(params)))


def _mesh_prompts(cfg) -> list:
    rng = np.random.default_rng(SEED + 7)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist()
            for n in MESH_PROMPT_LENS]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_lse_check(device="cuda") -> list:
    """The per-slot decode kernel with its log-sum-exp against the plain
    version at the shapes the phase gives it: one rank's shard of
    llama3.2-1b's pools at 524288 tokens ((1, 8192, 16, 8, 64), q (1, 32,
    64), bf16), at the local lengths the phase's decodes take (0: a shard
    past the length; a served prompt's; a shard full and one 64 short).
    The output with lse (fp32) rounds to the output without it, bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    cfg = get_config(MESH_ARCH)
    lp = MESH_MAX_LEN // MESH_PAGE // MESH_WORLD
    lt = lp * MESH_PAGE
    g = torch.Generator(device=device).manual_seed(SEED + 9)
    mk = lambda *s: torch.randn(*s, generator=g, device=device).to(
        torch.bfloat16)
    q = mk(1, cfg.n_heads, cfg.d_head)
    kp = mk(1, lp, MESH_PAGE, cfg.n_kv_heads, cfg.d_head)
    vp = mk(1, lp, MESH_PAGE, cfg.n_kv_heads, cfg.d_head)
    tbl = torch.arange(lp, dtype=torch.int32, device=device)[None]
    rows = []
    for n in (0, 1, max(MESH_PROMPT_LENS) + MESH_NEW, lt - MESH_FILL_GAP, lt):
        ln = torch.tensor([n], dtype=torch.int32, device=device)
        call = lambda: paged_attention(q, kp, vp, tbl, ln, return_lse=True)
        out, lse = call()
        plain = paged_attention(q, kp, vp, tbl, ln)
        ref, ref_lse = paged_attention_ref(q, kp, vp, tbl, ln,
                                           return_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if n == 0:
            assert torch.isneginf(lse).all() and torch.isneginf(ref_lse).all()
            assert (out == 0).all()
            lse_err = 0.0
        else:
            lse_err = (lse - ref_lse).abs().max().item()
        row = dict(shape=[list(q.shape), list(kp.shape)], length=n,
                   max_abs_err=err, tol=TOL[torch.bfloat16], lse_err=lse_err,
                   lse_tol=DECODE_LSE_TOL,
                   bit_equal_without_lse=torch.equal(out.to(q.dtype), plain))
        assert err <= TOL[torch.bfloat16] and lse_err <= DECODE_LSE_TOL, row
        assert row["bit_equal_without_lse"], row
        nbytes, flops = _slot_decode_bound(q, kp, tbl, ln)
        row.update(_decode_times(
            call, lambda: paged_attention_ref(q, kp, vp, tbl, ln,
                                              return_lse=True),
            nbytes + 4 * q.shape[0] * q.shape[1], flops, torch.bfloat16,
            plain_iters=3))
        without = lambda: paged_attention(q, kp, vp, tbl, ln)
        row["ms_without_lse"] = cuda_ms(without)
        row["device_ms_without_lse"] = _call_device(without)[0]
        row["library_ms"] = None
        emit("phase7 mesh lse", **row)
        rows.append(row)
    del q, kp, vp
    torch.cuda.empty_cache()
    return rows


def _mesh_serve(cfg, params, device, max_len, mi=None) -> dict:
    """One slot in copy mode serving the phase's prompts: tokens, each
    request's first-token logits, the launches (from 0 just before), the
    figures, and the decode call's device time at the last step's shape
    (this process's pools: a rank's shard under the mesh ``mi``)."""
    from repro_torch.core.serving.engine import ServingEngine
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.models import NO_MESH
    mi = mi or NO_MESH
    prompts = _mesh_prompts(cfg)
    eng = ServingEngine(cfg, params, 1, max_len, page_size=MESH_PAGE, mi=mi,
                        offload_mode="copy", device=device)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_tokens=MESH_NEW) for p in prompts]
    with _first_logits() as rows:
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _serve_launches()
    outs = [done[r].out_tokens for r in rids]
    s = check_serve(cfg, eng, outs, prompts, MESH_NEW)
    steps = s["decode_steps"]
    assert launches["paged_attention"] == cfg.n_layers * steps, launches
    assert launches["paged_attention_global"] == 0, launches
    assert launches["flash_attention_fwd"] == cfg.n_layers * len(prompts), \
        launches
    # the last decode's call again, at its shape (the last request's KV)
    kv = eng.cache[0]
    n_pages = kv.k_pool.shape[1]
    r = mi.mesh.get_local_rank("data") if mi.active else 0
    tbl = (kv.block_table[:, r * n_pages:(r + 1) * n_pages].long()
           % n_pages).to(torch.int32).contiguous()
    lt = n_pages * MESH_PAGE
    n = len(prompts[-1]) + MESH_NEW - 1
    ln = torch.tensor([min(max(n - r * lt, 0), lt)], dtype=torch.int32,
                      device=device)
    q = torch.zeros(1, cfg.n_heads, cfg.d_head, dtype=kv.k_pool.dtype,
                    device=device)
    return dict(tokens=outs,
               first_logits=torch.stack([lg.float() for _, _, lg, _ in rows])
               .cpu(),
               launches=launches, decode_steps=steps, prefills=s["prefills"],
               staging_copies=s["staging_copies"],
               ms_a_step=s["decode_s"] / steps * 1e3,
               **_serve_figures(s, done, wall),
               decode_call_shape=[list(q.shape), list(kv.k_pool.shape)],
               decode_call_length=int(ln),
               decode_call=lambda: paged_attention(q, kv.k_pool, kv.v_pool,
                                                   tbl, ln,
                                                   return_lse=mi.active))


def _mesh_layerwise(cfg, params, mi, device) -> float:
    """Decode on the mesh against prefill, one layer at a time, each layer
    fed the same hidden states (phase 3e's layer_rel): every layer of a
    one-device prefill of S + 1 tokens (no cache) against the same layer's
    prefill of the first S into the sequence-parallel layout on the mesh,
    then one sequence-parallel decode step of token S."""
    from repro_torch.models import init_cache
    from repro_torch.models.blocks import FwdCtx, apply_layer
    from repro_torch.models.model import _embed_in, layers
    S = MESH_LAYER_S
    g = torch.Generator(device=device).manual_seed(SEED + 10)
    toks = torch.randint(0, cfg.vocab_size, (1, S + 1), generator=g,
                         device=device)
    cache = init_cache(cfg, 1, MESH_MAX_LEN, MESH_PAGE, device=device, mi=mi)
    full = FwdCtx(cfg=cfg, mode="prefill")
    pre = FwdCtx(cfg=cfg, mode="prefill", mi=mi, sp=True)
    lengths = torch.full((1,), S, dtype=torch.int32, device=device)
    dec = FwdCtx(cfg=cfg, mode="decode", q_offset=lengths, mi=mi, sp=True)
    worst = 0.0
    with torch.no_grad():
        xs = [_embed_in(cfg, params, toks)]
        for li, (kind, p) in enumerate(layers(cfg, params)):
            x = xs[-1]
            _, cache[li] = apply_layer(kind, p, x[:, :S].contiguous(), pre,
                                       cache[li])
            xs.append(apply_layer(kind, p, x, full, None)[0])
        for li, (kind, p) in enumerate(layers(cfg, params)):
            x, x_next = xs[li][:, S:], xs[li + 1][:, S:]
            y, _ = apply_layer(kind, p, x.contiguous(), dec, cache[li])
            worst = max(worst, _rel(y - x, x_next - x))
    return worst


def _fill_shard(layer: int, which: int, rank: int, shape, device):
    """Seeded random K (which 0) or V (1) of one rank's shard of a layer."""
    g = torch.Generator(device=device).manual_seed(
        SEED + 1000 + 8 * layer + 2 * rank + which)
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)


def _mesh_fill(cfg, params, mi, rank, device) -> dict:
    """Every layer's pool filled with seeded random K/V to MESH_MAX_LEN -
    64 tokens (all four shards hold pages), then MESH_FILL_STEPS
    forward_decode steps on the mesh. Each rank's pools are held bit for
    bit against its seeded shard with the new tokens appended where it
    owns them; on rank 0, each layer's sequence-parallel output at each
    step against one decode over the whole unsharded pool (the per-slot
    kernel over 524288 tokens), at min(2e-2, 2e-2 * max|plain|)."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import attention as attn
    from repro_torch.models import forward_decode, init_cache
    from repro_torch.models.model import set_cache_length
    cache = init_cache(cfg, 1, MESH_MAX_LEN, MESH_PAGE, device=device, mi=mi)
    shape = tuple(cache[0].k_pool.shape)
    lp = shape[1]
    lt = lp * MESH_PAGE
    L = MESH_MAX_LEN - MESH_FILL_GAP
    for li, kv in enumerate(cache):
        kv.k_pool.copy_(_fill_shard(li, 0, rank, shape, device))
        kv.v_pool.copy_(_fill_shard(li, 1, rank, shape, device))
    cache = set_cache_length(cache, L)
    real, calls = attn.sp_paged_decode, []

    def recording(q, k_new, v_new, kv, mesh, **kw):
        o, kv2 = real(q, k_new, v_new, kv, mesh, **kw)
        calls.append((q.clone(), k_new.clone(), v_new.clone(), o.clone()))
        return o, kv2
    g = torch.Generator(device=device).manual_seed(SEED + 11)
    toks = torch.randint(0, cfg.vocab_size, (MESH_FILL_STEPS, 1, 1),
                         generator=g, device=device)
    step_ms = []
    with mock.patch.object(attn, "sp_paged_decode", recording), \
            torch.no_grad():
        for i in range(MESH_FILL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = forward_decode(
                cfg, params, toks[i],
                torch.full((1,), L + i, dtype=torch.int32, device=device),
                cache, mi)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            assert torch.isfinite(logits).all()
    n_layers = len(cache)
    assert len(calls) == n_layers * MESH_FILL_STEPS
    pools_equal = []
    for li, kv in enumerate(cache):
        for which, pool in ((0, kv.k_pool), (1, kv.v_pool)):
            want = _fill_shard(li, which, rank, shape, device)
            for i in range(MESH_FILL_STEPS):
                pos = L + i
                if pos // lt == rank:
                    new = calls[i * n_layers + li][1 + which]
                    want[0, (pos % lt) // MESH_PAGE, pos % MESH_PAGE] = \
                        new[0, 0]
            pools_equal.append(torch.equal(pool, want))
    out = dict(step_ms=step_ms, pools_equal=all(pools_equal),
               owners=sorted({(L + i) // lt for i in range(MESH_FILL_STEPS)}),
               local_length=min(max(L + 1 - rank * lt, 0), lt))
    if rank == 0:
        errs, tols, plain_err = [], [], None
        n_pages = lp * MESH_WORLD
        tbl = torch.arange(n_pages, dtype=torch.int32, device=device)[None]
        for li in range(n_layers):
            fk, fv = (torch.cat([_fill_shard(li, w, r, shape, device)
                                 for r in range(MESH_WORLD)], dim=1)
                      for w in (0, 1))
            for i in range(MESH_FILL_STEPS):
                q, kn, vn, o = calls[i * n_layers + li]
                pos = L + i
                fk[0, pos // MESH_PAGE, pos % MESH_PAGE] = kn[0, 0]
                fv[0, pos // MESH_PAGE, pos % MESH_PAGE] = vn[0, 0]
                ln = torch.tensor([pos + 1], dtype=torch.int32, device=device)
                one = paged_attention(q[:, 0].contiguous(), fk, fv, tbl, ln)
                errs.append((o[:, 0].float() - one.float()).abs().max().item())
                tols.append(min(TOL[torch.bfloat16], FLASH_REL_TOL
                                * one.float().abs().max().item()))
                if li == 0 and i == 0:
                    # the unsharded kernel itself against its plain version
                    ref = paged_attention_ref(q[:, 0].contiguous(), fk, fv,
                                              tbl, ln)
                    plain_err = (one.float() - ref.float()).abs().max().item()
                    del ref
            del fk, fv
        out.update(max_abs_err=max(errs), tol=min(tols),
                   within=all(e <= t for e, t in zip(errs, tols)),
                   unsharded_vs_plain_err=plain_err)
    return out


def _mesh_rank(rank: int, port: int, backend: str, tmp: str,
               device_type: str = "cuda") -> None:
    """One rank of phase 7: join the group, build the (4, 1) mesh, then
    (a) the copy-mode serve at 524288 tokens, (b) the layer-by-layer check
    and (c) the fill; results to ``tmp``/rank<r>.pt. Every rank runs the
    same engine on the same requests."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import MeshInfo, init_params
    device = torch.device(device_type, rank if backend == "nccl" else 0)
    init_distributed(rank, MESH_WORLD, f"tcp://localhost:{port}",
                     device=device, backend=backend)
    mesh = make_host_mesh(device=device_type)
    mi = MeshInfo(mesh)
    x = torch.full((2,), float(rank + 1), device=device)
    dist.all_reduce(x, group=mesh.get_group("data"))  # CUDA tensors reduce
    assert x.tolist() == [10.0, 10.0], x
    res = dict(rank=rank, device=str(device), backend=dist.get_backend(),
               device_name=torch.cuda.get_device_name(device),
               mesh_shape=list(mesh.shape),
               mesh_axes=list(mesh.mesh_dim_names))
    cfg = get_config(MESH_ARCH)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED),
                         device=device)
    res["weights_sum"] = _weights_sum(params)
    sv = _mesh_serve(cfg, params, device, MESH_MAX_LEN, mi=mi)
    call = sv.pop("decode_call")
    for r in range(MESH_WORLD):             # one rank at a time on the card
        dist.barrier()
        if r == rank:
            sv["decode_call_device_ms"] = _call_device(call)[0]
            sv["decode_call_ms"] = cuda_ms(call)
    dist.barrier()
    del call
    torch.cuda.empty_cache()
    res["serve"] = sv
    res["peak_gib_serve"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["layer_rel"] = _mesh_layerwise(cfg, params, mi, device)
    torch.cuda.empty_cache()
    res["fill"] = _mesh_fill(cfg, params, mi, rank, device)
    res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh(device_type: str = "cuda") -> dict:
    """7. Serving on a mesh: four ranks over torch.distributed, a (4, 1)
    ("data", "model") DeviceMesh (NCCL, one rank a card, with four cards;
    else gloo, all four on cuda:0: NCCL refuses two ranks on one device),
    llama3.2-1b at full width in bf16, one slot at 524288 tokens (the
    sequence-parallel layout: each rank holds a quarter of the pages, and
    each decode merges the ranks' partials, the decode kernel's own lse,
    by all-reduce). Here: the kernel's lse against the plain version at the
    phase's shapes, and the one-device engine at 262128 tokens (just under
    the layout's threshold) serving the same requests; then, in the ranks:
    (a) the serve in copy mode (bit-equal tokens across ranks, first-token
    logits and the equal-token count against the one-device serve, ms a
    step, each rank's decode call's device time), (b) decode on the mesh
    against prefill a layer at a time, (c) the fill over all four shards
    (outputs against the unsharded decode, pools bit for bit)."""
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.blocks import SP_MIN_LEN
    cfg = get_config(MESH_ARCH)
    lse_rows = _mesh_lse_check(device_type)
    params = init_params(cfg, torch.Generator(device=device_type)
                         .manual_seed(SEED), device=device_type)
    weights_sum = _weights_sum(params)
    one = _mesh_serve(cfg, params, device_type, SP_MIN_LEN - MESH_PAGE)
    one["decode_call_device_ms"] = _call_device(one.pop("decode_call"))[0]
    del params
    torch.cuda.empty_cache()
    emit("phase7 mesh one-device serve", arch=cfg.name, max_len=SP_MIN_LEN
         - MESH_PAGE, prompt_lens=list(MESH_PROMPT_LENS), new_tokens=MESH_NEW,
         **{k: v for k, v in one.items()
            if k not in ("tokens", "first_logits")})
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= MESH_WORLD else "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_mesh_rank, args=(_free_port(), backend, tmp,
                                         device_type),
                       nprocs=MESH_WORLD, join=False)
        while not ctx.join(timeout=5):      # a rank's failure raises here
            if time.perf_counter() - t0 > MESH_RANKS_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the mesh's ranks ran past "
                                   f"{MESH_RANKS_S} s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(MESH_WORLD)]
    ranks_s = time.perf_counter() - t0
    emit("phase7 mesh ranks", world_size=MESH_WORLD, backend=backend,
         cards=n_cards, devices=[r["device"] for r in ranks],
         device_names=[r["device_name"] for r in ranks],
         backends=[r["backend"] for r in ranks],
         mesh_shape=ranks[0]["mesh_shape"], mesh_axes=ranks[0]["mesh_axes"],
         ranks_s=ranks_s)
    r0 = ranks[0]
    assert all(r["weights_sum"] == weights_sum for r in ranks), \
        [r["weights_sum"] for r in ranks]
    sv = r0["serve"]
    equal_ranks = all(r["serve"]["tokens"] == sv["tokens"] for r in ranks)
    equal_logits = all(torch.equal(r["serve"]["first_logits"],
                                   sv["first_logits"]) for r in ranks)
    first_rel = [_rel(a, b) for a, b in zip(sv["first_logits"],
                                            one["first_logits"])]
    equal_tokens = sum(a == b for x, y in zip(sv["tokens"], one["tokens"])
                       for a, b in zip(x, y))
    row = dict(arch=cfg.name, max_len=MESH_MAX_LEN, page=MESH_PAGE,
               prompt_lens=list(MESH_PROMPT_LENS), new_tokens=MESH_NEW,
               tokens_equal_across_ranks=equal_ranks,
               first_logits_equal_across_ranks=equal_logits,
               first_token_rel=first_rel,
               equal_tokens_vs_one_device=equal_tokens,
               tokens=sum(len(t) for t in sv["tokens"]),
               ms_a_step=sv["ms_a_step"],
               ms_a_step_ranks=[r["serve"]["ms_a_step"] for r in ranks],
               one_device_ms_a_step=one["ms_a_step"],
               decode_call_device_ms_ranks=[
                   r["serve"]["decode_call_device_ms"] for r in ranks],
               decode_call_ms_ranks=[r["serve"]["decode_call_ms"]
                                     for r in ranks],
               decode_call_length_ranks=[r["serve"]["decode_call_length"]
                                         for r in ranks],
               decode_call_shape=sv["decode_call_shape"],
               one_device_decode_call_device_ms=one["decode_call_device_ms"],
               one_device_decode_call_shape=one["decode_call_shape"],
               launches=sv["launches"], decode_steps=sv["decode_steps"],
               prefills=sv["prefills"], staging_copies=sv["staging_copies"],
               ttft_ms_median=sv["ttft_ms_median"],
               peak_gib_ranks=[r["peak_gib_serve"] for r in ranks])
    emit("phase7 mesh serve", **row)
    assert equal_ranks and equal_logits, "the ranks served different tokens"
    assert max(first_rel) < LOGIT_REL, first_rel
    layer_rel = [r["layer_rel"] for r in ranks]
    emit("phase7 mesh decode-vs-prefill", S=MESH_LAYER_S, layer_rel=layer_rel)
    assert max(layer_rel) < LOGIT_REL, layer_rel
    fill = dict(r0["fill"], pools_equal_ranks=[r["fill"]["pools_equal"]
                                               for r in ranks],
                local_lengths=[r["fill"]["local_length"] for r in ranks],
                step_ms_ranks=[r["fill"]["step_ms"] for r in ranks],
                length=MESH_MAX_LEN - MESH_FILL_GAP, steps=MESH_FILL_STEPS,
                peak_gib_ranks=[r["peak_gib"] for r in ranks])
    del fill["pools_equal"], fill["local_length"], fill["step_ms"]
    emit("phase7 mesh fill", **fill)
    assert all(fill["pools_equal_ranks"]), fill
    assert fill["within"] and fill["unsharded_vs_plain_err"] <= \
        TOL[torch.bfloat16], fill
    assert all(n > 0 for n in fill["local_lengths"]), fill
    return dict(lse=lse_rows, launches=sv["launches"], serve=row,
                one_device=one["launches"])


# ------------------------------------------------------------------ phase 8

MT_ARCH = "llama3.2-1b"
MT_LAYERS = 2           # full width, depth cut: over gloo on one card every
                        # gathered block and every all-reduce goes through
                        # the host (3.4-131.8 ms a collective of 1-64 MB on
                        # NVIDIA H100 80GB HBM3, 700 W; PERF.md §5)
MT_MESH = (2, 2)
MT_ELASTIC = (4, 1)
MT_STEPS = 3
MT_LR = 3e-4
# the mesh's step against the one-device step on the same weights and
# batches (bf16: the row-parallel products sum their bf16 partials over
# 'model' and each block's gradient sums over 'data', in other orders)
MT_LOSS_REL = 2e-3      # each step's loss (phase 6's limit as built)
MT_GNORM_REL = 2e-2     # each step's gradient norm
MT_STATE_REL = 0.1      # params and master after the steps: sum |mesh - one|
                        # over sum |one - initial| (the steps' own change)
MT_RANKS_S = 600


def _card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _mt_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MT_ARCH), n_layers=MT_LAYERS)


def _mt_tc():
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(lr=MT_LR, warmup_steps=1, total_steps=10)


def _mt_batches(cfg, device, B: int = TRAIN_B, S: int = TRAIN_S) -> list:
    """MT_STEPS + 1 batches of random tokens (B, S), phase 6's shape,
    drawn on the CPU from one seed, so every process holds the same; for
    a cross-attention arch each also has its source, ``enc_x`` or
    ``img_x`` (B, ``_src_len(cfg)``, d), random, drawn after the tokens."""
    from repro_torch.models.params import torch_dtype
    g = torch.Generator().manual_seed(SEED + 31)
    mk = lambda: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    out = [{"tokens": mk().to(device), "labels": mk().to(device)}
           for _ in range(MT_STEPS + 1)]
    if cfg.is_encdec or cfg.n_image_tokens:
        key = "img_x" if cfg.n_image_tokens else "enc_x"
        for b in out:
            b[key] = torch.randn((B, _src_len(cfg), cfg.d_model),
                                 generator=g).to(
                device, torch_dtype(cfg.activation_dtype))
    return out


def _mt_params(cfg, device, mi=None):
    """The phase's weights (seeded; wq and wk x 0.1, phase 6's "scaled"
    set, on which attention is not chaotic; every cross gate CROSS_GATE,
    where the init draws 0); on a mesh the rank's blocks of the same
    tree."""
    from repro_torch.models import NO_MESH, init_params
    g = torch.Generator(device=device).manual_seed(SEED + 30)
    params = _qk_scaled(init_params(cfg, g, device, mi=mi or NO_MESH))
    for blk in params["blocks"]:
        for layer in blk.values():
            if "xattn" in layer:
                layer["xattn"]["gate"].fill_(CROSS_GATE)
    return params


def _mt_counted(sh, mi) -> bool:
    """Whether this rank's block of a leaf placed by ``sh`` is the one that
    counts: the first of the ranks that hold the same block."""
    split = set(sh.split)
    return all(c == 0 for a, c in sh.coords
               if a not in split and mi.size(a) > 1)


def _mt_diff(state, ref, start, shards=None, mi=None) -> dict:
    """``rel``: sum |state - ref| over sum |ref - start| over every leaf
    (fp64), the discrepancy against the steps' own change; the largest
    |state - ref|; the share of entries that differ. On a mesh over every
    rank's blocks, each block counted once."""
    from repro_torch.models.dist import all_reduce
    from repro_torch.tree import leaves
    flat = leaves(state)
    shs = leaves(shards) if shards is not None else [None] * len(flat)
    dev = flat[0].device
    sums = torch.zeros(4, dtype=torch.float64, device=dev)
    big = torch.zeros((), dtype=torch.float64, device=dev)
    n = 2 ** 24             # elements at a time: fp64 copies of a whole
                            # leaf would not fit beside a rank's state
    for a, b, p, sh in zip(flat, leaves(ref), leaves(start), shs):
        counted = sh is None or _mt_counted(sh, mi)
        for a_, b_, p_ in zip(*(t.reshape(-1).split(n) for t in (a, b, p))):
            d = (a_.double() - b_.double()).abs()
            big = torch.maximum(big, d.max())
            if counted:
                sums += torch.stack([
                    d.sum(), (b_.double() - p_.double()).abs().sum(),
                    (d != 0).sum().double(),
                    torch.full((), d.numel(), dtype=torch.float64,
                               device=dev)])
    if mi is not None:
        sums = all_reduce(sums, mi, mi.axis_names)
        big = all_reduce(big, mi, mi.axis_names, op="max")
    return dict(rel=(sums[0] / sums[1]).item(), max_abs=big.item(),
                differ_share=(sums[2] / sums[3]).item())


def _mt_hold(losses, gnorms, ref_losses, ref_gnorms, params, master) -> dict:
    """The readings of (a) against the one-device step, and whether they
    are within the limits."""
    rel = lambda a, b: abs(a - b) / abs(b)
    row = dict(loss_rel=[rel(a, b) for a, b in zip(losses, ref_losses)],
               gnorm_rel=[rel(a, b) for a, b in zip(gnorms, ref_gnorms)],
               params=params, master=master)
    row["within"] = (max(row["loss_rel"]) <= MT_LOSS_REL
                     and max(row["gnorm_rel"]) <= MT_GNORM_REL
                     and params["rel"] <= MT_STATE_REL
                     and master["rel"] <= MT_STATE_REL)
    return row


def _mt_ref_state(params, opt) -> dict:
    from repro_torch.models.params import stack_blocks
    return {"params": stack_blocks(params), "master": stack_blocks(opt.master)}


def _mt_reference(cfg, tc, batches, device, ref_dir, data: int) -> dict:
    """The one-device steps on the same weights and batches: MT_STEPS + 1
    steps, the state after MT_STEPS and after the last written to
    ``ref_dir`` (params and master, in the reference's layout) for the
    ranks to read their blocks of; ms a step and the peak GiB. Then the
    planted fault: the same MT_STEPS steps on data rank 0's rows alone
    (B / ``data``), what a step whose gradients missed the other data
    ranks' rows would give, held as the mesh is."""
    from repro_torch.checkpoint.ckpt import save
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import tree_map
    params = _mt_params(cfg, device)
    start = tree_map(torch.clone, params)
    opt = init_opt_state(params)
    step = make_train_step(cfg, tc)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = dict(loss=[], grad_norm=[], ms=[])
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        out["loss"].append(m["loss"].item())
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norm"].append(m["grad_norm"].item())
        if i + 1 >= MT_STEPS:
            save(ref_dir, i + 1, _mt_ref_state(params, opt))
        if i + 1 == MT_STEPS:
            held = tree_map(torch.clone, (params, opt.master))
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, opt
    fparams = _mt_params(cfg, device)
    fopt = init_opt_state(fparams)
    rows = batches[0]["tokens"].shape[0] // data
    fl, fg = [], []
    for b in batches[:MT_STEPS]:
        fparams, fopt, m = step(fparams, fopt,
                                {k: v[:rows] for k, v in b.items()})
        fl.append(m["loss"].item())
        fg.append(m["grad_norm"].item())
    out["fault"] = _mt_hold(fl, fg, out["loss"][:MT_STEPS],
                            out["grad_norm"][:MT_STEPS],
                            _mt_diff(fparams, held[0], start),
                            _mt_diff(fopt.master, held[1], start))
    return out


def _mt_bits(t) -> np.ndarray:
    """The bits of a tensor's or an array's values (bf16 as int16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy().view(np.int32 if t.element_size() == 4 else np.int8)
    return np.asarray(t).view(np.int16 if t.dtype.itemsize == 2 else
                              np.int32)


def _mt_equal_to_file(ck_dir: str, step: int, state, shards) -> bool:
    """Whether every leaf of ``state`` (this rank's blocks, or whole where
    ``shards`` is None) equals its block of the checkpoint's file bit for
    bit."""
    from repro_torch.tree import leaves
    d = os.path.join(ck_dir, f"step_{step}")
    flat = leaves(state)
    shs = leaves(shards) if shards is not None else [None] * len(flat)
    for i, (t, sh) in enumerate(zip(flat, shs)):
        arr = np.load(os.path.join(d, f"leaf_{i}.npy"), mmap_mode="r")
        if sh is not None:
            arr = sh.cut(arr)
        if not np.array_equal(_mt_bits(t), _mt_bits(np.array(arr))):
            return False
    return True


def _mt_replicas_equal(tree, shards, mi) -> bool:
    """Whether every block held by more than one rank (the axes of size >
    1 a leaf is not split on) equals, bit for bit, the copy of the axis's
    first rank, which broadcasts it 2^24 entries at a time (a whole leaf
    gathered over four ranks would not fit beside their state:
    seamless's 1 GB fp32 table on (1, 4)). Every rank returns the same
    answer, over the whole mesh (its callers stop at the first False)."""
    import torch.distributed as dist
    from repro_torch.models.dist import all_reduce, axis_group
    from repro_torch.tree import leaves
    flat = leaves(tree)
    ok = True
    for t, sh in zip(flat, leaves(shards)):
        for a in mi.axis_names:
            if a in sh.split or mi.size(a) == 1:
                continue
            group = axis_group(mi, a)
            first = dist.get_global_rank(group, 0)
            for part in t.reshape(-1).split(2 ** 24):
                theirs = part.clone()
                dist.broadcast(theirs, first, group=group)
                ok &= torch.equal(theirs, part)
    differ = torch.tensor(float(not ok), device=flat[0].device)
    return all_reduce(differ, mi, mi.axis_names, op="max").item() == 0


MT_COLLECTIVE_MB = (1, 16, 64)


def _mt_collectives(mi, device) -> dict:
    """ms of the step's collectives alone (``models.dist``'s all_gather,
    reduce_scatter and all_reduce over the 'data' axis, 2 ranks) on a
    bf16 block of each size a rank, the median of 3 after one, each from
    a barrier to its result on the device."""
    import torch.distributed as dist
    from repro_torch.models.dist import all_gather, all_reduce, reduce_scatter
    ops = {"all_gather": lambda x: all_gather(x, 0, mi, "data"),
           "reduce_scatter": lambda x: reduce_scatter(x, 0, mi, "data"),
           "all_reduce": lambda x: all_reduce(x, mi, "data")}
    out = {}
    for mb in MT_COLLECTIVE_MB:
        x = torch.ones(mb * 2 ** 19, dtype=torch.bfloat16, device=device)
        for name, op in ops.items():
            times = []
            for _ in range(4):
                dist.barrier()
                t0 = time.perf_counter()
                op(x)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{name}_{mb}MB"] = statistics.median(times[1:])
    return out


def _mt_steps(step, params, opt, batches) -> tuple:
    times, losses, gnorms = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(m["grad_norm"].item())
    return params, opt, dict(loss=losses, grad_norm=gnorms, ms=times)


@contextlib.contextmanager
def _embed_used():
    """Records, at every loss of ``forward_train``, the path it takes
    ("vocab_parallel" or "whole") and the embedding leaves' shapes as the
    loss uses them (gathered over the batch axes; over ``model`` too where
    the vocab does not split)."""
    from repro_torch.models import model
    calls = []

    def recording(name, fn):
        def rec(emb, *a, **kw):
            calls.append(dict(path=name, **{k: list(v.shape)
                                            for k, v in emb.items()}))
            return fn(emb, *a, **kw)
        return rec

    with mock.patch.object(model, "chunked_xent",
                           recording("whole", model.chunked_xent)), \
            mock.patch.object(model, "vocab_parallel_xent",
                              recording("vocab_parallel",
                                        model.vocab_parallel_xent)):
        yield calls


def _embed_expected(cfg, shape) -> dict:
    """The embedding leaves' shapes a rank of ``shape`` (data, model) uses:
    the vocab over model where it divides, else whole."""
    m = shape[1]
    split = m > 1 and cfg.vocab_size % m == 0
    v = cfg.vocab_size // m if split else cfg.vocab_size
    out = dict(path="vocab_parallel" if split else "whole",
               table=[v, cfg.d_model])
    if not cfg.tie_embeddings:
        out["head"] = [cfg.d_model, v]
    return out


def _embed_reading(calls: list) -> dict:
    """The first loss's record, and whether every loss used the same."""
    return dict(calls[0], losses=len(calls),
                alike=all(c == calls[0] for c in calls))


def _embed_ok(reading: dict, want: dict) -> bool:
    """Whether every loss of a run used the path and shapes ``want``."""
    return reading["alike"] and {k: v for k, v in reading.items()
                                 if k not in ("losses", "alike")} == want


@contextlib.contextmanager
def _label_clamp():
    """The planted fault of the vocab-parallel loss: each rank takes the
    logit at its label clamped into its vocab block, where the label
    should be masked (every rank adds a wrong logit to the gold)."""
    from repro_torch.models import layers

    def clamped(logits, labels, v0):
        n = logits.shape[-1]
        return torch.gather(logits, -1,
                            (labels - v0).clamp(0, n - 1)[..., None])[..., 0]

    with mock.patch.object(layers, "_vocab_gold", clamped):
        yield


def _mt_rank(rank: int, port: int, backend: str, tmp: str, ref: dict,
             device_type: str = "cuda", B: int = TRAIN_B,
             S: int = TRAIN_S, cfg=None) -> None:
    """One rank of phase 8: (a) MT_STEPS steps on the (2, 2) mesh, held
    against the one-device steps (``ref``; the state from ``tmp``/ref),
    every local shape against its resolved spec, flash launches, peak
    memory and the embedding leaves' shapes as used; the same steps under
    the label-clamp fault, held alike; (b) the replicas; (c) a save on
    (2, 2), the restore on (4, 1), bit for bit against the file, and one
    more step there, held against the one-device step. Results to
    ``tmp``/rank<r>.pt."""
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.kernels import flash_attention_fwd, reset_launch_counts
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import (ckpt_shardings, ckpt_state,
                                          from_ckpt_state)
    from repro_torch.models import MeshInfo
    from repro_torch.models.params import (model_specs, shardings,
                                           stack_blocks, stack_specs)
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves, tree_map
    cuda = device_type == "cuda"
    device = (torch.device("cuda", rank if backend == "nccl" else 0)
              if cuda else torch.device("cpu"))
    init_distributed(rank, MESH_WORLD, f"tcp://localhost:{port}",
                     device=device, backend=backend)
    cfg = cfg or _mt_cfg()
    tc = _mt_tc()
    batches = _mt_batches(cfg, device, B, S)
    res = dict(rank=rank, device=str(device), backend=dist.get_backend())

    def one_mesh(shape):
        mi = MeshInfo(make_mesh(shape, ("data", "model"), device=device_type))
        return (mi, shardings(model_specs(cfg), mi),
                shardings(stack_specs(model_specs(cfg)), mi))

    def held(mi, stacked, params, opt, start, at):
        now = _mt_ref_state(params, opt)
        got = restore(os.path.join(tmp, "ref"), at, now,
                      shardings={"params": stacked, "master": stacked})
        init = stack_blocks(start)
        return (_mt_diff(now["params"], got["params"], init, stacked, mi),
                _mt_diff(now["master"], got["master"], init, stacked, mi))

    # (a) the steps on (2, 2)
    mi, sh, stacked = one_mesh(MT_MESH)
    res["collectives_ms"] = _mt_collectives(mi, device)
    params = _mt_params(cfg, device, mi)
    start = tree_map(torch.clone, params)
    opt = init_opt_state(params)
    res["local_shapes_ok"] = all(
        tuple(t.shape) == s_.local_shape(spec.shape)
        for t, s_, spec in zip(leaves(params), leaves(sh),
                               leaves(model_specs(cfg))))
    res["local_params"] = sum(t.numel() for t in leaves(params))
    step = make_train_step(cfg, tc, mi)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    with _embed_used() as used:
        params, opt, res["steps"] = _mt_steps(step, params, opt,
                                              batches[:MT_STEPS])
    res["embed_used"] = _embed_reading(used)
    res["flash_launches"] = flash_attention_fwd.launches
    res["flash_wgmma_launches"] = flash_attention_fwd.wgmma_launches
    if cuda:
        res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    p_diff, m_diff = held(mi, stacked, params, opt, start, MT_STEPS)
    res["a"] = _mt_hold(res["steps"]["loss"], res["steps"]["grad_norm"],
                        ref["loss"][:MT_STEPS], ref["grad_norm"][:MT_STEPS],
                        p_diff, m_diff)
    # (b) the replicas
    res["replicas_equal"] = all(_mt_replicas_equal(t, sh, mi) for t in
                                (params, opt.master, opt.mu, opt.nu))
    # the planted fault: the same steps with the label clamped, not masked
    fparams = _mt_params(cfg, device, mi)
    with _label_clamp():
        fparams, fopt, fsteps = _mt_steps(step, fparams,
                                          init_opt_state(fparams),
                                          batches[:MT_STEPS])
    p_diff, m_diff = held(mi, stacked, fparams, fopt, start, MT_STEPS)
    res["label_fault"] = _mt_hold(fsteps["loss"], fsteps["grad_norm"],
                                  ref["loss"][:MT_STEPS],
                                  ref["grad_norm"][:MT_STEPS],
                                  p_diff, m_diff)
    del fparams, fopt
    # (c) save on (2, 2), restore on (4, 1), one more step
    ck = os.path.join(tmp, "ck")
    state = ckpt_state(params, opt)
    placed = ckpt_shardings(cfg, mi, False)
    t0 = time.perf_counter()
    save(ck, MT_STEPS, state, shardings=placed, mi=mi)
    res["save_s"] = time.perf_counter() - t0
    res["saved_equal"] = _mt_equal_to_file(ck, MT_STEPS, state, placed)
    del params, opt, state, start
    mi2, sh2, stacked2 = one_mesh(MT_ELASTIC)
    start2 = _mt_params(cfg, device, mi2)
    target = ckpt_state(start2, init_opt_state(start2))
    placed2 = ckpt_shardings(cfg, mi2, False)
    t0 = time.perf_counter()
    state2 = restore(ck, MT_STEPS, target, shardings=placed2)
    res["restore_s"] = time.perf_counter() - t0
    res["restored_equal"] = _mt_equal_to_file(ck, MT_STEPS, state2, placed2)
    params2, opt2 = from_ckpt_state(state2)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with _embed_used() as used:
        params2, opt2, res["elastic_step"] = _mt_steps(
            make_train_step(cfg, tc, mi2), params2, opt2, batches[MT_STEPS:])
    res["embed_used_elastic"] = _embed_reading(used)
    if cuda:
        res["elastic_peak_gib"] = (torch.cuda.max_memory_allocated(device)
                                   / 2 ** 30)
    p_diff, m_diff = held(mi2, stacked2, params2, opt2, start2,
                          MT_STEPS + 1)
    res["c"] = _mt_hold(res["elastic_step"]["loss"],
                        res["elastic_step"]["grad_norm"],
                        ref["loss"][MT_STEPS:], ref["grad_norm"][MT_STEPS:],
                        p_diff, m_diff)
    res["replicas_equal_elastic"] = all(
        _mt_replicas_equal(t, sh2, mi2)
        for t in (params2, opt2.master, opt2.mu, opt2.nu))
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _mt_flash(cfg, mesh=MT_MESH, phase="phase8 mesh train flash",
              B: int = TRAIN_B, S: int = TRAIN_S,
              dtype=torch.bfloat16) -> dict:
    """(d) The flash kernel at the local shape of a rank of ``mesh`` in a
    step of batch (B, S): its rows (B / data) over its heads (q and KV
    heads / model), causal, with lse (``_flash_row``)."""
    d, m = mesh
    hq = cfg.n_heads // m
    return _flash_row(phase, dict(arch=cfg.name, mesh=list(mesh)), dtype,
                      B // d, S, S, hq, _rank_kv_heads(cfg, m), cfg.d_head,
                      True)


def _rank_kv_heads(cfg, m: int) -> int:
    """A model rank's KV heads: n_kv_heads / m where they split, else each
    of its q heads' own (``blocks._tp_kv_heads``)."""
    hq = cfg.n_heads // m
    return (cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0
            else -(-hq // (cfg.n_heads // cfg.n_kv_heads)))


def _flash_row(phase: str, head: dict, dtype, B: int, Sq: int, Skv: int,
               hq: int, hkv: int, D: int, causal: bool) -> dict:
    """The flash kernel at one shape a step gives it, with lse: out and lse
    against the plain version, times (with and without lse, plain, SDPA
    with K/V repeated) and the bound; emitted as a ``phase`` row after
    ``head``'s fields."""
    from repro_torch.kernels import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    q, k, v = _flash_inputs(g, dtype, B, Sq, Skv, hq, hkv, D)
    kw = dict(causal=causal, window=None, softcap=None, q_offset=0)
    check = _flash_check(q, k, v, kw)
    out, lse = flash_attention_fwd(q, k, v, **kw, return_lse=True)
    _, ref_lse = flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, flash_attention_fwd(q, k, v, **kw)), \
        "flash: out differs with and without lse"
    lse_err = (lse - ref_lse).abs().max().item()
    assert torch.isfinite(lse).all() and lse_err <= LSE_TOL, lse_err
    G = hq // hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    fl = _flash_flops(B, Sq, Skv, hq, D, causal, None, 0)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    bound, by = _bound(nbytes + lse.numel() * 4, fl, q.dtype)
    row = dict(**head, dtype=str(dtype), causal=causal,
               shape=[B, Sq, hq, hkv, D], skv=Skv, **check,
               lse_err=lse_err, lse_tol=LSE_TOL,
               ms=cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
               ms_lse=cuda_ms(lambda: flash_attention_fwd(
                   q, k, v, **kw, return_lse=True)),
               plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                warmup=1, iters=3),
               library_ms=cuda_ms(lambda: torch.nn.functional
                                  .scaled_dot_product_attention(
                                      qt, kt, vt, is_causal=causal)),
               bound_ms=bound, bound_by=by)
    emit(phase, **row)
    return row


def phase_mesh_train(device_type: str = "cuda") -> dict:
    """8. Training on a mesh: four ranks over torch.distributed on a (2, 2)
    ("data", "model") DeviceMesh (NCCL, one rank a card, with four cards;
    else gloo, all four on cuda:0), llama3.2-1b at full width in bf16 on
    MT_LAYERS layers, B 4 x 2048 (2 x 2048 a data rank), each rank its
    blocks of every parameter and optimizer buffer (FSDP over data, TP
    over model). Here: (d) flash at a rank's shape; the one-device steps
    on the same weights and batches, and the planted fault (the steps on
    one data rank's rows). Then the ranks: (a) three steps held against
    the one-device steps (loss, gradient norm, params and master), the
    embedding leaves' shapes as used (a rank's vocab block), and the
    same steps under the label-clamp fault, which must miss; (b) the
    replicas bit for bit; (c) the save on (2, 2), the restore on (4, 1)
    bit for bit and one more step there, held alike (the table whole).
    Last the restore on one device, bit for bit."""
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.checkpoint.ckpt import restore
    from repro_torch.launch.train import ckpt_state
    from repro_torch.optim import init_opt_state
    card = _card_line()
    cfg, tc = _mt_cfg(), _mt_tc()
    flash = _mt_flash(cfg)
    tmp = tempfile.mkdtemp(prefix=".mesh_train_", dir=HERE)
    try:
        batches = _mt_batches(cfg, device_type)
        ref = _mt_reference(cfg, tc, batches, device_type,
                            os.path.join(tmp, "ref"), MT_MESH[0])
        del batches
        torch.cuda.empty_cache()
        fault = ref.pop("fault")
        n_cards = torch.cuda.device_count()
        backend = "nccl" if n_cards >= MESH_WORLD else "gloo"
        t0 = time.perf_counter()
        ctx = mp.spawn(_mt_rank, args=(_free_port(), backend, tmp, ref,
                                       device_type),
                       nprocs=MESH_WORLD, join=False)
        while not ctx.join(timeout=5):      # a rank's failure raises here
            if time.perf_counter() - t0 > MT_RANKS_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the ranks ran past {MT_RANKS_S} s")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(MESH_WORLD)]
        # the restore on one device
        whole = _mt_params(cfg, device_type)
        target = ckpt_state(whole, init_opt_state(whole))
        state = restore(os.path.join(tmp, "ck"), MT_STEPS, target)
        one_equal = _mt_equal_to_file(os.path.join(tmp, "ck"), MT_STEPS,
                                      state, None)
        del whole, target, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    launches = [r["flash_launches"] for r in ranks]
    row = dict(card=card, arch=MT_ARCH, layers=MT_LAYERS,
               mesh=list(MT_MESH), elastic=list(MT_ELASTIC),
               batch=[TRAIN_B, TRAIN_S], steps=MT_STEPS, backend=backend,
               cards=n_cards, devices=[r["device"] for r in ranks],
               ranks_s=ranks_s,
               limits=dict(loss_rel=MT_LOSS_REL, gnorm_rel=MT_GNORM_REL,
                           state_rel=MT_STATE_REL),
               one_device=ref, a=r0["a"], fault=fault,
               a_equal_across_ranks=all(r["a"] == r0["a"] for r in ranks),
               losses_equal_across_ranks=all(
                   r["steps"]["loss"] == r0["steps"]["loss"] for r in ranks),
               ms_ranks=[r["steps"]["ms"] for r in ranks],
               ms_median=statistics.median(r0["steps"]["ms"]),
               one_device_ms_median=statistics.median(ref["ms"]),
               peak_gib_ranks=[r.get("peak_gib") for r in ranks],
               one_device_peak_gib=ref.get("peak_gib"),
               embed_used=r0["embed_used"],
               embed_used_ranks_alike=all(
                   r["embed_used"] == r0["embed_used"] for r in ranks),
               embed_expected=_embed_expected(cfg, MT_MESH),
               label_fault=r0["label_fault"],
               local_params_ranks=[r["local_params"] for r in ranks],
               local_shapes_ok=all(r["local_shapes_ok"] for r in ranks),
               flash_launches_ranks=launches,
               flash_launches_a_rank_a_step=launches[0] / MT_STEPS,
               replicas_equal=all(r["replicas_equal"] for r in ranks),
               collectives_ms=r0["collectives_ms"])
    emit("phase8 mesh train", **row)
    elastic = dict(saved_equal=[r["saved_equal"] for r in ranks],
                   restored_equal=[r["restored_equal"] for r in ranks],
                   one_device_equal=one_equal, c=r0["c"],
                   elastic_ms=[r["elastic_step"]["ms"] for r in ranks],
                   elastic_peak_gib=[r.get("elastic_peak_gib")
                                     for r in ranks],
                   embed_used=r0["embed_used_elastic"],
                   embed_expected=_embed_expected(cfg, MT_ELASTIC),
                   save_s=[r["save_s"] for r in ranks],
                   restore_s=[r["restore_s"] for r in ranks],
                   replicas_equal=all(r["replicas_equal_elastic"]
                                      for r in ranks))
    emit("phase8 mesh train elastic", **elastic)
    assert row["local_shapes_ok"] and row["losses_equal_across_ranks"], row
    assert row["a"]["within"], row["a"]
    assert not fault["within"], fault
    assert row["embed_used_ranks_alike"], row
    assert not row["label_fault"]["within"], row["label_fault"]
    for used, want in ((row["embed_used"], row["embed_expected"]),
                       (elastic["embed_used"], elastic["embed_expected"])):
        assert _embed_ok(used, want), (used, want)
    assert all(n == 2 * MT_LAYERS * MT_STEPS for n in launches), launches
    assert all(r["flash_wgmma_launches"] == n
               for r, n in zip(ranks, launches)), launches
    assert row["replicas_equal"] and elastic["replicas_equal"], row
    assert all(elastic["saved_equal"]) and all(elastic["restored_equal"]) \
        and one_equal, elastic
    assert elastic["c"]["within"], elastic["c"]
    return dict(flash=flash, launches=launches[0], row=row)


# ------------------------------------------------------------------ phase 9

MZ_ARCH = "olmoe-1b-7b"
MZ_LAYERS = 1           # full width, depth cut (2 layers until phase 11
                        # came; the steps are each layer's 805 MB of
                        # experts gathered through the host, over gloo on
                        # one card)
MZ_WHOLE = (4, 1)       # experts whole: the yardstick. Every mesh of four
                        # routes in G = gcd(T, 4) = 4 token groups, no mesh
                        # in 1, so the one-device step is not one
MZ_MESHES = ((2, 2), (1, 4))     # 32 and 16 of the 64 experts a rank
MZ_SAVE, MZ_RESTORE = (2, 2), (1, 4)
MZ_VARIANT = (1, 4)     # the planted fault and the sound variant
MZ_SMOKE_ARCH = "kimi-k2-1t-a32b"   # a dense first layer, a shared expert
MZ_SMOKE_B, MZ_SMOKE_S = 4, 64
MZ_RANKS_S = 900
# one step a mesh, where phases 8 and 11 take MT_STEPS (3): with phase 11
# the whole script took 1,020-1,052 s of its 1,200 on NVIDIA H100 80GB
# HBM3, 700.00 W, and a slower host ran its gloo steps up to 1.8 times
# slower (PERF.md §5); phases 9 and 10 spend most of theirs in steps
MZ_STEPS = 1
# The routers' master against the (4, 1) steps' (0.02% of the weights: the
# sum over every leaf cannot see them). A router entry's first AdamW steps
# follow its gradient's sign, so two runs whose router gradients share no
# sign information read ~1 (independent steps of lr against a change of
# lr); half of that is the limit. Rounding moves a few signs: bf16 sums in
# another order flip ~1% of layer 0's (token, choice) pairs, each moving a
# token between two experts' capacity buffers.
MZ_ROUTER_REL = 0.5
# The witness, (1, 4) with every routing replayed from the (4, 1) steps:
# no pair routes otherwise, so the state falls from ~0.07 towards a dense
# MLP's reading (phase 8: 0.0056; the witness read 0.012 on an H100).
# A fault in the expert-parallel sums would not hide under this limit.
MZ_REPLAY_REL = 0.03


def _mz_cfg(smoke: bool = False):
    from repro_torch.configs import get_config, reduce_for_smoke
    if smoke:
        return reduce_for_smoke(get_config(MZ_SMOKE_ARCH))
    return dataclasses.replace(get_config(MZ_ARCH), n_layers=MZ_LAYERS)


@contextlib.contextmanager
def _router_fault():
    """The planted fault: the MoE layer's tensor-parallel form without the
    router's ``copy_to``, so each model rank keeps its own experts' part of
    the router's gradient."""
    from repro_torch.models import blocks
    from repro_torch.models.dist import copy_to, reduce_from
    real = blocks._apply_moe

    def no_router_sum(p, x, ctx):
        if not ctx.tp:
            return real(p, x, ctx)
        x = copy_to(x, ctx.mi, "model")
        y = blocks.moe_ffn(p, x, ctx.cfg, ctx.mi, row_axes=ctx.grad_axes)
        return reduce_from(y, ctx.mi, "model")
    with mock.patch.object(blocks, "_apply_moe", no_router_sum):
        yield


@contextlib.contextmanager
def _plain_moe():
    """The sound variant: the step with the plain MoE FFN (the reference's
    one-hot einsums, ``moe_ffn_ref``) on the rank's experts."""
    from repro_torch.models import blocks
    from repro_torch.models.moe import moe_ffn_ref
    with mock.patch.object(blocks, "moe_ffn", moe_ffn_ref):
        yield


@contextlib.contextmanager
def _route_log():
    """While a model runs, records every MoE routing's top-K experts in
    call order, as ``route`` returns them ((T, K), on the card)."""
    from repro_torch.models import moe
    real, rec = moe.route, []

    def logged(p, x2, cfg):
        experts, gates = real(p, x2, cfg)
        rec.append(experts)
        return experts, gates
    with mock.patch.object(moe, "route", logged):
        yield rec


@contextlib.contextmanager
def _replayed_routes(plan):
    """The witness: every MoE routing takes its experts from ``plan`` (one
    (T, K) tensor a call, in call order) and its gates from its own
    router's probabilities at those experts, renormalised as ``route``
    does (replaying a run's own routing gives its gates bit for bit).
    Every call of the plan must be used."""
    from repro_torch.models import moe
    calls = iter(plan)
    used = []

    def replay(p, x2, cfg):
        experts = next(calls)
        assert experts.shape[0] == x2.shape[0], (experts.shape, x2.shape)
        probs = torch.softmax(x2.float() @ p["router"], dim=-1)
        gates = probs.gather(1, experts)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        used.append(1)
        return experts, gates
    with mock.patch.object(moe, "route", replay):
        yield
    assert len(used) == len(plan), (len(used), len(plan))


def _mz_whole_routes(log, mi) -> list:
    """The (4, 1) ranks' routings as the whole batch's, call by call: each
    rank's (T / data, K) experts gathered over data, rows in data order
    (the rows a (1, 4) rank holds)."""
    from repro_torch.models.dist import all_gather
    return list(all_gather(torch.stack(log), 1, mi, "data").unbind(0))


def _mz_shards(cfg, mi) -> tuple:
    from repro_torch.models.params import model_specs, shardings, stack_specs
    return (shardings(model_specs(cfg), mi),
            shardings(stack_specs(model_specs(cfg)), mi))


def _mesh_run(cfg, tc, batches, mi, sh, device) -> tuple:
    """A step a batch on ``mi`` from the phase's weights (the rank's
    blocks): (params, opt, the initial params, readings: each step's loss,
    norm and ms, peak GiB, flash launches from 0, whether every leaf has
    its local shape, the embedding leaves' shapes as the loss used
    them)."""
    from repro_torch.kernels import flash_attention_fwd, reset_launch_counts
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import model_specs
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves, tree_map
    params = _mt_params(cfg, device, mi)
    start = tree_map(torch.clone, params)
    opt = init_opt_state(params)
    out = dict(local_shapes_ok=all(
        tuple(t.shape) == s_.local_shape(spec.shape)
        for t, s_, spec in zip(leaves(params), leaves(sh),
                               leaves(model_specs(cfg)))))
    step = make_train_step(cfg, tc, mi)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    with _embed_used() as used:
        params, opt, out["steps"] = _mt_steps(step, params, opt, batches)
    out["embed_used"] = _embed_reading(used)
    out["flash_launches"] = flash_attention_fwd.launches
    out["flash_wgmma_launches"] = flash_attention_fwd.wgmma_launches
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return params, opt, start, out


def _mz_run(cfg, tc, batches, mi, sh, device) -> tuple:
    """``_mesh_run`` with the MoE readings: layer 0's first routing of the
    rank's rows, the (token, choice) pairs of every MoE call and those
    dropped past capacity."""
    with _routes() as routes, _moe_drops() as drops:
        params, opt, start, out = _mesh_run(cfg, tc, batches, mi, sh,
                                            device)
    out["routes0"] = routes[0].cpu()
    calls = drops["prefill"]
    out["pairs"] = sum(n for n, _ in calls)
    out["dropped"] = int(sum(d for _, d in calls)) if calls else 0
    return params, opt, start, out


def _mesh_held(mi, stacked, params, opt, start, ref_dir,
               parts=None) -> dict:
    """This rank's params and master after its steps against the
    yardstick's (its blocks of ``ref_dir``'s files, the last step saved
    there), as ``_mt_diff``; and each of
    ``parts`` ({name: a function of a tree to a list of its leaves}) of the
    master alone."""
    from repro_torch.checkpoint.ckpt import latest_step, restore
    from repro_torch.models.params import stack_blocks
    now = _mt_ref_state(params, opt)
    got = restore(ref_dir, latest_step(ref_dir), now,
                  shardings={"params": stacked, "master": stacked})
    init = stack_blocks(start)
    out = {k: _mt_diff(now[k], got[k], init, stacked, mi)
           for k in ("params", "master")}
    for name, part in (parts or {}).items():
        out[name] = _mt_diff(part(now["master"]), part(got["master"]),
                             part(init), part(stacked), mi)
    return out


def _mz_held(mi, stacked, params, opt, start, ref_dir) -> dict:
    """``_mesh_held`` against the (4, 1) steps, with the routers' master
    alone: the routers are 0.02% of the weights, so the sum over every
    leaf cannot see them."""
    return _mesh_held(mi, stacked, params, opt, start, ref_dir, parts={
        "router": lambda t: [t["blocks"]["0"]["moe"]["router"]]})


def _mz_hold(steps: dict, ref: dict, held: dict) -> dict:
    """Phase 8's readings and limits against the (4, 1) steps, and the
    routers' master within MZ_ROUTER_REL."""
    row = _mt_hold(steps["loss"], steps["grad_norm"], ref["loss"],
                   ref["grad_norm"], held["params"], held["master"])
    row["router"] = held["router"]
    row["within"] = bool(row["within"]
                         and held["router"]["rel"] <= MZ_ROUTER_REL)
    return row


def _mz_moe_ms(cfg, meshes: dict, device, B: int, S: int) -> dict:
    """Device ms (CUDA events) of one ``moe_ffn`` call on a rank's experts,
    on rank 0 alone while the others wait: each mesh's rank-0 rows of the
    phase's batch (B / data of them) through its experts (E / model),
    bf16, seeded, in the token groups of the global batch."""
    import torch.distributed as dist
    from repro_torch.models.moe import local_groups, moe_ffn
    out = {}
    dist.barrier()
    if dist.get_rank() == 0 and device.type == "cuda":
        g = torch.Generator(device=device).manual_seed(SEED + 40)
        d_, E, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff
        rnd = lambda *shape: torch.randn(shape, generator=g, device=device)
        for shape, mi in meshes.items():
            E_l, rows = E // shape[1], B // shape[0]
            axes = ("data",) if shape[0] > 1 else ()
            x = rnd(rows, S, d_).to(torch.bfloat16)
            p = {"router": rnd(d_, E) * d_ ** -0.5,
                 "w_gate": (rnd(E_l, d_, ff) * d_ ** -0.5).to(torch.bfloat16),
                 "w_up": (rnd(E_l, d_, ff) * d_ ** -0.5).to(torch.bfloat16),
                 "w_down": (rnd(E_l, ff, d_) * ff ** -0.5).to(torch.bfloat16)}
            with torch.no_grad():
                ms = cuda_ms(lambda: moe_ffn(p, x, cfg, mi, row_axes=axes))
            out[str(shape)] = dict(experts=E_l, tokens=rows * S,
                                   groups=local_groups(rows * S, mi, axes),
                                   ms=ms)
    dist.barrier()
    return out


def _smoke_held(cfg, tc, mesh, device, B: int, S: int, whole_shape,
                shapes, steps: int = MT_STEPS) -> dict:
    """A smoke config (fp32) ``steps`` steps on ``whole_shape`` and on each
    of ``shapes``, each state gathered whole; each of ``shapes`` against
    ``whole_shape`` with phase 8's readings and limits, its replicas and
    flash launches, and the yardstick's replicas, by str(shape)."""
    from repro_torch.models.dist import gather_whole
    from repro_torch.tree import leaves
    batches = _mt_batches(cfg, device, B, S)[:steps]
    runs = {}
    for shape in (whole_shape,) + tuple(shapes):
        mi = mesh(shape)
        sh, _ = _mz_shards(cfg, mi)
        params, opt, start, run = _mesh_run(cfg, tc, batches, mi, sh,
                                            device)
        whole = lambda tree: [gather_whole(t, s_, mi)
                              for t, s_ in zip(leaves(tree), leaves(sh))]
        run["replicas_equal"] = all(_mt_replicas_equal(t, sh, mi) for t in
                                    (params, opt.master, opt.mu, opt.nu))
        runs[shape] = (whole(params), whole(opt.master), whole(start), run)
    p1, m1, s1, r1 = runs[whole_shape]
    out = {}
    for shape in shapes:
        p2, m2, _, r2 = runs[shape]
        row = _mt_hold(r2["steps"]["loss"], r2["steps"]["grad_norm"],
                       r1["steps"]["loss"], r1["steps"]["grad_norm"],
                       _mt_diff(p2, p1, s1), _mt_diff(m2, m1, s1))
        row["replicas_equal"] = r2["replicas_equal"] and r1["replicas_equal"]
        row["flash_launches"] = r2["flash_launches"]
        out[str(shape)] = row
    return out


def _mz_smoke(tc, mesh, device) -> dict:
    """kimi-k2 at smoke size (fp32: a dense first layer, a shared expert):
    MZ_STEPS steps on (2, 2) against (4, 1), each state gathered whole;
    phase 8's readings and limits, and the replicas."""
    return _smoke_held(_mz_cfg(smoke=True), tc, mesh, device, MZ_SMOKE_B,
                       MZ_SMOKE_S, MZ_WHOLE, (MZ_SAVE,),
                       MZ_STEPS)[str(MZ_SAVE)]


def _mz_rank(rank: int, port: int, backend: str, tmp: str,
             device_type: str = "cuda", B: int = TRAIN_B, S: int = TRAIN_S,
             cfg=None) -> None:
    """One rank of phase 9. (b) MZ_STEPS steps on (4, 1), experts whole,
    its params and master saved as the yardstick; the same steps on (2, 2)
    and (1, 4), experts split, held against it, with each rank's routing
    of layer 0, its dropped pairs, flash launches, peak GiB and the
    replicas; (d) the (2, 2) state saved and restored on (1, 4), bit for
    bit against the file; the planted fault, the sound variant and the
    witness (every routing replayed from the (4, 1) steps) on (1, 4); one
    ``moe_ffn`` call timed on (2, 2) and (4, 1) experts; kimi-k2 at smoke
    size on (2, 2) against (4, 1). Results to ``tmp``/rank<r>.pt."""
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import MeshInfo
    from repro_torch.models.dist import axis_rank
    cuda = device_type == "cuda"
    device = (torch.device("cuda", rank if backend == "nccl" else 0)
              if cuda else torch.device("cpu"))
    init_distributed(rank, MESH_WORLD, f"tcp://localhost:{port}",
                     device=device, backend=backend)
    cfg = cfg or _mz_cfg()
    tc = _mt_tc()
    batches = _mt_batches(cfg, device, B, S)[:MZ_STEPS]
    res = dict(rank=rank, device=str(device), backend=dist.get_backend(),
               runs={}, coords={}, batch=(B, S))
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = MeshInfo(make_mesh(shape, ("data", "model"),
                                               device=device_type))
            res["coords"][str(shape)] = [axis_rank(meshes[shape], a)
                                         for a in ("data", "model")]
        return meshes[shape]

    def release():
        if cuda:
            torch.cuda.empty_cache()

    ref_dir, ck = os.path.join(tmp, "ref"), os.path.join(tmp, "ck")
    mi = mesh(MZ_WHOLE)
    sh, stacked = _mz_shards(cfg, mi)
    with _route_log() as log:
        params, opt, _, ref = _mz_run(cfg, tc, batches, mi, sh, device)
    plan = _mz_whole_routes(log, mi)
    del log
    save(ref_dir, MZ_STEPS, _mt_ref_state(params, opt),
         shardings={"params": stacked, "master": stacked}, mi=mi)
    res["runs"][str(MZ_WHOLE)] = ref
    del params, opt
    release()
    both = lambda st: {"params": st, "master": st}
    for shape in MZ_MESHES:
        mi = mesh(shape)
        sh, stacked = _mz_shards(cfg, mi)
        params, opt, start, run = _mz_run(cfg, tc, batches, mi, sh, device)
        run["held"] = _mz_hold(run["steps"], ref["steps"], _mz_held(
            mi, stacked, params, opt, start, ref_dir))
        run["replicas_equal"] = all(_mt_replicas_equal(t, sh, mi) for t in
                                    (params, opt.master, opt.mu, opt.nu))
        state = _mt_ref_state(params, opt)
        if shape == MZ_SAVE:
            t0 = time.perf_counter()
            save(ck, MZ_STEPS, state, shardings=both(stacked), mi=mi)
            run["save_s"] = time.perf_counter() - t0
            run["saved_equal"] = _mt_equal_to_file(ck, MZ_STEPS, state,
                                                   both(stacked))
        if shape == MZ_RESTORE:
            t0 = time.perf_counter()
            got = restore(ck, MZ_STEPS, state, shardings=both(stacked))
            run["restore_s"] = time.perf_counter() - t0
            run["restored_equal"] = _mt_equal_to_file(ck, MZ_STEPS, got,
                                                      both(stacked))
            del got
        res["runs"][str(shape)] = run
        del params, opt, start, state
        release()
    mi = mesh(MZ_VARIANT)
    sh, stacked = _mz_shards(cfg, mi)
    for name, variant in (("fault", _router_fault), ("sound", _plain_moe),
                          ("replayed", lambda: _replayed_routes(plan))):
        with variant():
            params, opt, start, run = _mz_run(cfg, tc, batches, mi, sh,
                                              device)
        run["held"] = _mz_hold(run["steps"], ref["steps"], _mz_held(
            mi, stacked, params, opt, start, ref_dir))
        run["replicas_equal"] = all(_mt_replicas_equal(t, sh, mi) for t in
                                    (params, opt.master, opt.mu, opt.nu))
        res[name] = run
        del params, opt, start
        release()
    del plan
    res["moe_ms"] = _mz_moe_ms(cfg, {s: mesh(s) for s in (MZ_SAVE, MZ_WHOLE)},
                               device, B, S)
    res["smoke"] = _mz_smoke(tc, mesh, device)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _mz_routes(ranks, shape):
    """Layer 0's first routing of the whole batch on ``shape`` (T, K), from
    the model-rank-0 ranks in data order; and whether every model rank of
    a data rank routed alike."""
    key = str(shape)
    by = {}
    for r in ranks:
        d, m = r["coords"][key]
        by.setdefault(d, []).append(r["runs"][key]["routes0"])
    alike = all(torch.equal(t, ts[0]) for ts in by.values() for t in ts)
    return torch.cat([by[d][0] for d in sorted(by)]), alike


def phase_mesh_moe(device_type: str = "cuda") -> dict:
    """9. MoE training on a mesh: four ranks as in 8, olmoe-1b-7b at full
    width in bf16 cut to MZ_LAYERS layers (wq, wk x 0.1), B 4 x 2048, each
    rank its blocks of every parameter and optimizer buffer: the experts
    split over model (expert parallelism), d over data (FSDP). Here: (a)
    flash at a (2, 2) rank's shape, q (2, 2048, 8, 128) over (2, 2048, 8,
    128), with lse, against the plain version; the same at a (1, 4) and a
    (4, 1) rank's shape, and at kimi-k2's smoke shapes (fp32, D 16) on
    (4, 1) and (2, 2): every shape the ranks' steps give it. Then the
    ranks (_mz_rank): (b) one step on (2, 2) and (1, 4) against one on
    (4, 1), all in G = 4 token groups (loss 2e-3, gradient norm 2e-2,
    params and master 0.1 of the steps' own change, the routers' master
    0.5), which the planted fault must miss (its routers unequal across
    ranks too) and the sound variant meet; the (token, choice) pairs of
    layer 0 routed otherwise than on (4, 1); the witness, (1, 4) with
    every routing replayed from the (4, 1) steps, held alike and its
    state and routers within 0.03 (MZ_REPLAY_REL); (c) the
    replicated leaves bit for bit; (d) the (2, 2) save restored on (1, 4)
    bit for bit; readings: ms a step, peak GiB, flash launches, one
    moe_ffn call's device ms, the dropped share; kimi-k2 at smoke size.
    A rank's failure fails the phase."""
    import shutil
    import torch.multiprocessing as mp
    card = _card_line()
    cfg = _mz_cfg()
    flash = _mt_flash(cfg, MZ_SAVE, "phase9 mesh moe flash")
    shapes = [flash] + [_mt_flash(cfg, s, "phase9 mesh moe flash")
                        for s in (MZ_RESTORE, MZ_WHOLE)]
    shapes += [_mt_flash(_mz_cfg(smoke=True), s, "phase9 mesh moe flash",
                         MZ_SMOKE_B, MZ_SMOKE_S, torch.float32)
               for s in (MZ_WHOLE, MZ_SAVE)]
    torch.cuda.empty_cache()        # the ranks share this card with us
    tmp = tempfile.mkdtemp(prefix=".mesh_moe_", dir=HERE)
    try:
        n_cards = torch.cuda.device_count()
        backend = "nccl" if n_cards >= MESH_WORLD else "gloo"
        t0 = time.perf_counter()
        ctx = mp.spawn(_mz_rank, args=(_free_port(), backend, tmp,
                                       device_type),
                       nprocs=MESH_WORLD, join=False)
        while not ctx.join(timeout=5):      # a rank's failure raises here
            if time.perf_counter() - t0 > MZ_RANKS_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the ranks ran past {MZ_RANKS_S} s")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(MESH_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _mz_check(ranks, cfg, dict(
        card=card, backend=backend, cards=n_cards, ranks_s=ranks_s))
    return dict(flash=flash, shapes=shapes, launches=launches)


def _mz_check(ranks, cfg, head: dict) -> int:
    """Phase 9's rows from the ranks' results, and its gates; returns the
    flash launches of a (2, 2) rank."""
    r0 = ranks[0]
    whole_routes, _ = _mz_routes(ranks, MZ_WHOLE)
    meshes = {}
    for shape in (MZ_WHOLE,) + MZ_MESHES:
        key = str(shape)
        runs = [r["runs"][key] for r in ranks]
        routes, alike = _mz_routes(ranks, shape)
        meshes[key] = dict(
            experts_a_rank=cfg.moe.n_experts // shape[1],
            ms_ranks=[x["steps"]["ms"] for x in runs],
            ms_median=statistics.median(runs[0]["steps"]["ms"]),
            loss=runs[0]["steps"]["loss"],
            grad_norm=runs[0]["steps"]["grad_norm"],
            losses_equal_across_ranks=all(
                x["steps"]["loss"] == runs[0]["steps"]["loss"] for x in runs),
            peak_gib_ranks=[x.get("peak_gib") for x in runs],
            embed_used=runs[0]["embed_used"],
            embed_ok=all(_embed_ok(x["embed_used"],
                                   _embed_expected(cfg, shape))
                         for x in runs),
            flash_launches_ranks=[x["flash_launches"] for x in runs],
            flash_wgmma_ranks=[x["flash_wgmma_launches"] for x in runs],
            local_shapes_ok=all(x["local_shapes_ok"] for x in runs),
            pairs=runs[0]["pairs"], dropped=runs[0]["dropped"],
            dropped_share=runs[0]["dropped"] / max(runs[0]["pairs"], 1),
            routes_alike_across_model=alike,
            layer0_pairs=routes.numel(),
            layer0_pairs_routed_otherwise=int((routes != whole_routes).sum()))
        if shape != MZ_WHOLE:
            meshes[key].update(
                held=runs[0]["held"],
                held_equal_across_ranks=all(x["held"] == runs[0]["held"]
                                            for x in runs),
                replicas_equal=all(x["replicas_equal"] for x in runs))
    variants = {name: dict(held=r0[name]["held"],
                           replicas_equal=all(r[name]["replicas_equal"]
                                              for r in ranks),
                           ms_median=statistics.median(
                               r0[name]["steps"]["ms"]))
                for name in ("fault", "sound", "replayed")}
    save, rest = r0["runs"][str(MZ_SAVE)], r0["runs"][str(MZ_RESTORE)]
    elastic = dict(saved=list(MZ_SAVE), restored=list(MZ_RESTORE),
                   saved_equal=[r["runs"][str(MZ_SAVE)]["saved_equal"]
                                for r in ranks],
                   restored_equal=[r["runs"][str(MZ_RESTORE)]
                                   ["restored_equal"] for r in ranks],
                   save_s=save["save_s"], restore_s=rest["restore_s"])
    smoke = r0["smoke"]
    row = dict(**head, arch=cfg.name, layers=cfg.n_layers,
               batch=list(r0["batch"]), steps=MZ_STEPS,
               devices=[r["device"] for r in ranks],
               limits=dict(loss_rel=MT_LOSS_REL, gnorm_rel=MT_GNORM_REL,
                           state_rel=MT_STATE_REL, router_rel=MZ_ROUTER_REL,
                           replayed_rel=MZ_REPLAY_REL),
               meshes=meshes, variant_mesh=list(MZ_VARIANT), **variants,
               moe_ms=r0["moe_ms"])
    emit("phase9 mesh moe", **row)
    emit("phase9 mesh moe elastic", **elastic)
    emit("phase9 mesh moe smoke", arch=MZ_SMOKE_ARCH,
         batch=[MZ_SMOKE_B, MZ_SMOKE_S],
         smoke_equal_across_ranks=all(r["smoke"] == smoke for r in ranks),
         **smoke)
    split = meshes[str(MZ_SAVE)]
    for key, m in meshes.items():
        assert m["local_shapes_ok"] and m["losses_equal_across_ranks"], m
        assert m["routes_alike_across_model"], key
        assert m["embed_ok"], (key, m["embed_used"])
        if key != str(MZ_WHOLE):
            assert m["held"]["within"], (key, m["held"])
            assert m["replicas_equal"], (key, m)
    assert not variants["fault"]["held"]["within"], variants["fault"]
    assert not variants["fault"]["replicas_equal"], variants["fault"]
    for name in ("sound", "replayed"):
        assert variants[name]["held"]["within"], (name, variants[name])
        assert variants[name]["replicas_equal"], (name, variants[name])
    replayed = variants["replayed"]["held"]
    assert max(replayed[k]["rel"] for k in ("params", "master", "router")) \
        <= MZ_REPLAY_REL, replayed
    for key, m in meshes.items():
        n = m["flash_launches_ranks"]
        assert all(x == 2 * cfg.n_layers * MZ_STEPS for x in n), (key, n)
        if head["cards"]:
            assert m["flash_wgmma_ranks"] == n, (key, m)
    assert smoke["flash_launches"] > 0, smoke
    launches = split["flash_launches_ranks"]
    assert all(elastic["saved_equal"]) and all(elastic["restored_equal"]), \
        elastic
    assert smoke["within"] and smoke["replicas_equal"], smoke
    return launches[0]


# ------------------------------------------------------------------ phase 10

MR_RWKV = "rwkv6-3b"
MR_LAYERS = 2           # full width, depth cut as phases 8 and 9
MR_MESHES = ((2, 2), (1, 4), (4, 1))     # 20, 10 and 40 of 40 heads a rank
MR_SAVE, MR_RESTORE = (2, 2), (1, 4)
MR_JAMBA = "jamba-1.5-large-398b"
# jamba's one-layer cut: its first layer, the mamba mixer (d_in 16384)
# before the dense GLU MLP (d_ff 24576), with the untied embedding and head:
# ~2.1 B parameters, ~33 GB of training state. B 4 x 128: the scan's (B, T,
# d_in, N) fp32 tensors, ~25 of them live in a recomputed block's backward,
# are 0.54 GB each on one device and 0.13 GB on a rank of four, where each
# rank also holds the embedding and head gathered whole with their
# gradients (4.3 GB); four such ranks share the card (PERF.md §6)
MR_JAMBA_B, MR_JAMBA_S = 4, 128
# (4, 1) first: jamba's witness, the mesh without tensor parallelism (its
# steps differ from one device's by FSDP's bf16 gradient sums alone). At
# step 3 its gradient norm reads 2.15e-2 of the one-device step's on an
# H100, past phase 8's 2e-2 (PERF.md §6), so the tensor-parallel meshes'
# norm is held within MR_WITNESS_FACTOR times its reading where larger
MR_WITNESS = (4, 1)
MR_JAMBA_MESHES = (MR_WITNESS, (2, 2), (1, 4))
MR_WITNESS_FACTOR = 2
MR_FAULT = (1, 4)       # the planted fault's mesh
MR_SMOKE_B, MR_SMOKE_S = 4, 64
MR_SMOKE_WHOLE = (4, 1)  # the smoke yardstick: experts and widths whole,
                         # and every mesh of four routes in 4 token groups
MR_SMOKE_MESHES = ((2, 2), (1, 4))
MR_SMOKE_LOSS_REL = 1e-5    # fp32: each step's loss against (4, 1)
MR_RANKS_S = 900
MR_STEPS = 1            # as phase 9's MZ_STEPS
# the mixers' leaves, whose master is read alone beside the whole state's
# (the embedding and head are most of the weights and take most of the
# steps' change, so the sum over every leaf hardly sees a mixer's fault)
MR_MIXERS = {"rwkv": ("tm", "cm"), "jamba": ("mamba",)}


def _mr_mixer(which: str):
    """A function of a stacked tree to the leaves of its mixers."""
    from repro_torch.tree import leaves
    return lambda t: [x for k in MR_MIXERS[which]
                      for x in leaves(t["blocks"]["0"][k])]


def _mr_hold(steps: dict, ref: dict, held: dict,
             gnorm_rel: float = MT_GNORM_REL) -> dict:
    """Phase 8's readings and limits against the one-device steps, the
    gradient norm's limit ``gnorm_rel`` (None: the witness, whose norm
    sets the others' limit), and the mixers' master within MT_STATE_REL
    too."""
    row = _mt_hold(steps["loss"], steps["grad_norm"], ref["loss"],
                   ref["grad_norm"], held["params"], held["master"])
    row["mixer"] = held["mixer"]
    row["gnorm_limit"] = gnorm_rel
    row["within"] = bool(max(row["loss_rel"]) <= MT_LOSS_REL
                         and (gnorm_rel is None
                              or max(row["gnorm_rel"]) <= gnorm_rel)
                         and max(held[k]["rel"] for k in
                                 ("params", "master", "mixer"))
                         <= MT_STATE_REL)
    return row


def _mr_cfg(which: str):
    """rwkv6-3b at full width on MR_LAYERS layers; jamba at full width on
    its first layer; or jamba at smoke size on JAMBA_CUT layers (every
    kind, fp32)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    if which == "rwkv":
        return dataclasses.replace(get_config(MR_RWKV), n_layers=MR_LAYERS)
    cfg = get_config(MR_JAMBA)
    n = 1
    if which == "smoke":
        cfg, n = reduce_for_smoke(cfg), JAMBA_CUT
    return dataclasses.replace(cfg, n_layers=n,
                               block_pattern=cfg.block_pattern[:n])


MR_BATCH = {"rwkv": (TRAIN_B, TRAIN_S), "jamba": (MR_JAMBA_B, MR_JAMBA_S),
            "smoke": (MR_SMOKE_B, MR_SMOKE_S)}


@contextlib.contextmanager
def _in_proj_fault():
    """The planted fault: mamba's in_proj block, the contiguous columns
    [r 2c, (r+1) 2c) of [xi | z], taken as (xi, z), as the one-device
    split does with the whole matrix. The shapes line up, so nothing
    raises."""
    from repro_torch.models import mamba
    from repro_torch.models.dist import copy_to

    def contiguous(p, x, mi):
        return torch.chunk(copy_to(x, mi, "model") @ p["in_proj"], 2, dim=-1)
    with mock.patch.object(mamba, "_tp_in_proj", contiguous):
        yield


def _mr_one_device(cfg, tc, batches, device, ref_dir) -> dict:
    """The one-device steps on the phase's weights and batches: each
    step's loss, norm and ms, the peak GiB; the state after the last
    written to ``ref_dir`` (params and master, the reference's layout) for
    the ranks to read their blocks of."""
    from repro_torch.checkpoint.ckpt import save
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    params = _mt_params(cfg, device)
    opt = init_opt_state(params)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params, opt, out = _mt_steps(make_train_step(cfg, tc), params, opt,
                                 batches)
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    save(ref_dir, len(batches), _mt_ref_state(params, opt))
    return out


def _mr_rank(rank: int, port: int, backend: str, tmp: str,
             device_type: str = "cuda", cfgs=None, sizes=None) -> None:
    """One rank of phase 10. rwkv6-3b on MR_MESHES and jamba's full-width
    cut on MR_JAMBA_MESHES (the (4, 1) witness first), MR_STEPS steps
    each, their state against the one-device steps' (``tmp``/rwkv,
    ``tmp``/jamba), the replicas, ms a step, peak GiB; rwkv6's (2, 2) state saved and restored on (1, 4), bit
    for bit against the file; the planted fault on jamba's (1, 4); jamba
    at smoke size on MR_SMOKE_MESHES against MR_SMOKE_WHOLE. ``cfgs`` and
    ``sizes`` replace ``_mr_cfg`` and MR_BATCH (a rehearsal at small
    size). Results to ``tmp``/rank<r>.pt."""
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import MeshInfo
    from repro_torch.models.dist import axis_rank
    cuda = device_type == "cuda"
    device = (torch.device("cuda", rank if backend == "nccl" else 0)
              if cuda else torch.device("cpu"))
    init_distributed(rank, MESH_WORLD, f"tcp://localhost:{port}",
                     device=device, backend=backend)
    cfgs = cfgs or {k: _mr_cfg(k) for k in MR_BATCH}
    sizes = sizes or MR_BATCH
    tc = _mt_tc()
    res = dict(rank=rank, device=str(device), backend=dist.get_backend(),
               coords={}, rwkv={}, jamba={})
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = MeshInfo(make_mesh(shape, ("data", "model"),
                                               device=device_type))
            res["coords"][str(shape)] = [axis_rank(meshes[shape], a)
                                         for a in ("data", "model")]
        return meshes[shape]

    def run(which, shape, variant=contextlib.nullcontext):
        cfg, mi = cfgs[which], mesh(shape)
        sh, stacked = _mz_shards(cfg, mi)
        batches = _mt_batches(cfg, device, *sizes[which])[:MR_STEPS]
        with variant():
            params, opt, start, out = _mesh_run(cfg, tc, batches, mi, sh,
                                                device)
        out["held"] = _mesh_held(mi, stacked, params, opt, start,
                                 os.path.join(tmp, which),
                                 parts={"mixer": _mr_mixer(which)})
        out["replicas_equal"] = all(_mt_replicas_equal(t, sh, mi) for t in
                                    (params, opt.master, opt.mu, opt.nu))
        return params, opt, stacked, out

    def release():
        if cuda:
            torch.cuda.empty_cache()

    ck = os.path.join(tmp, "ck")
    both = lambda st: {"params": st, "master": st}
    for shape in MR_MESHES:
        params, opt, stacked, out = run("rwkv", shape)
        state = _mt_ref_state(params, opt)
        if shape == MR_SAVE:
            t0 = time.perf_counter()
            save(ck, MR_STEPS, state, shardings=both(stacked), mi=mesh(shape))
            out["save_s"] = time.perf_counter() - t0
            out["saved_equal"] = _mt_equal_to_file(ck, MR_STEPS, state,
                                                   both(stacked))
        if shape == MR_RESTORE:
            t0 = time.perf_counter()
            got = restore(ck, MR_STEPS, state, shardings=both(stacked))
            out["restore_s"] = time.perf_counter() - t0
            out["restored_equal"] = _mt_equal_to_file(ck, MR_STEPS, got,
                                                      both(stacked))
            del got
        res["rwkv"][str(shape)] = out
        del params, opt, state
        release()
    for shape in MR_JAMBA_MESHES:
        res["jamba"][str(shape)] = run("jamba", shape)[3]
        release()
    res["fault"] = run("jamba", MR_FAULT, _in_proj_fault)[3]
    release()
    res["smoke"] = _smoke_held(cfgs["smoke"], tc, mesh, device,
                               *sizes["smoke"], MR_SMOKE_WHOLE,
                               MR_SMOKE_MESHES, MR_STEPS)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh_recurrent(device_type: str = "cuda", cfgs=None,
                         sizes=None) -> dict:
    """10. Recurrent training on a mesh: four ranks as in 8, each rank its
    blocks of every parameter and optimizer buffer (rwkv6's heads, mamba's
    d_in and the MLP's d_ff over model, d over data). Here: flash at every
    rank shape jamba's smoke steps give it (fp32 D 16) against the plain
    version with lse; the one-device steps of rwkv6-3b (full width, 2
    layers, bf16, B 4 x 2048) and of jamba's full-width mamba layer (B 4 x
    128) on the phase's weights and batches. Then the ranks
    (``_mr_rank``): one step of rwkv6-3b on (2, 2), (1, 4) and (4, 1),
    and of jamba's layer on (4, 1), (2, 2) and (1, 4), each held against
    the one-device steps (loss 2e-3, gradient norm 2e-2, params and master
    0.1 of the steps' own change, the mixers' master 0.1 too; jamba's
    gradient norm within twice the (4, 1) witness's reading where that is
    larger, MR_WITNESS); jamba's (1, 4) again with in_proj's
    contiguous block taken as (xi, z), which must miss; the replicated
    leaves bit for bit; rwkv6's (2, 2) save restored on (1, 4) bit for
    bit; jamba at smoke size on its five-layer cut on (2, 2) and (1, 4)
    against (4, 1), each step's loss within 1e-5 and phase 8's limits;
    readings: ms a step, peak GiB a rank, flash launches. A rank's
    failure fails the phase."""
    import shutil
    import torch.multiprocessing as mp
    card = _card_line()
    cfgs = cfgs or {k: _mr_cfg(k) for k in MR_BATCH}
    sizes = sizes or MR_BATCH
    cuda = device_type == "cuda"
    flash = ([_mt_flash(cfgs["smoke"], s, "phase10 mesh recurrent flash",
                        *sizes["smoke"], torch.float32)
              for s in (MR_SMOKE_WHOLE,) + MR_SMOKE_MESHES] if cuda else [])
    tc = _mt_tc()
    tmp = tempfile.mkdtemp(prefix=".mesh_recurrent_", dir=HERE)
    try:
        one = {}
        for which in ("rwkv", "jamba"):
            batches = _mt_batches(cfgs[which], device_type,
                                  *sizes[which])[:MR_STEPS]
            one[which] = _mr_one_device(cfgs[which], tc, batches,
                                        device_type,
                                        os.path.join(tmp, which))
            del batches
            if cuda:
                torch.cuda.empty_cache()   # the ranks share this card
        n_cards = torch.cuda.device_count() if cuda else 0
        backend = "nccl" if n_cards >= MESH_WORLD else "gloo"
        parent_gib = (torch.cuda.memory_reserved() / 2 ** 30 if cuda
                      else None)
        # the ranks' blocks of jamba's layer come and go in sizes that
        # fragment a fixed-segment cache; four such ranks fill the card
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        t0 = time.perf_counter()
        ctx = mp.spawn(_mr_rank, args=(_free_port(), backend, tmp,
                                       device_type, cfgs, sizes),
                       nprocs=MESH_WORLD, join=False)
        while not ctx.join(timeout=5):      # a rank's failure raises here
            if time.perf_counter() - t0 > MR_RANKS_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the ranks ran past {MR_RANKS_S} s")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(MESH_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _mr_check(ranks, one, cfgs, sizes, dict(
        card=card, backend=backend, cards=n_cards, ranks_s=ranks_s,
        parent_reserved_gib=parent_gib))
    return dict(flash=flash, launches=launches)


def _mr_meshes(ranks, key: str, ref: dict, gnorm=None) -> dict:
    """Each mesh's row of ``key``'s runs (rwkv or jamba) against the
    one-device steps ``ref``; ``gnorm``: {mesh: its gradient norm's limit}
    (default phase 8's)."""
    out = {}
    for shape, r0 in ranks[0][key].items():
        runs = [r[key][shape] for r in ranks]
        out[shape] = dict(
            held=_mr_hold(r0["steps"], ref, r0["held"],
                          (gnorm or {}).get(shape, MT_GNORM_REL)),
            held_equal_across_ranks=all(x["held"] == r0["held"]
                                        for x in runs),
            loss=r0["steps"]["loss"], grad_norm=r0["steps"]["grad_norm"],
            losses_equal_across_ranks=all(
                x["steps"]["loss"] == r0["steps"]["loss"] for x in runs),
            ms_ranks=[x["steps"]["ms"] for x in runs],
            ms_median=statistics.median(r0["steps"]["ms"]),
            peak_gib_ranks=[x.get("peak_gib") for x in runs],
            local_shapes_ok=all(x["local_shapes_ok"] for x in runs),
            replicas_equal=all(x["replicas_equal"] for x in runs),
            flash_launches_ranks=[x["flash_launches"] for x in runs])
    return out


def _mr_check(ranks, one: dict, cfgs: dict, sizes: dict, head: dict) -> int:
    """Phase 10's rows from the ranks' results, and its gates; returns the
    flash launches of a (2, 2) rank in jamba's smoke steps."""
    r0 = ranks[0]
    rel = lambda a, b: abs(a - b) / abs(b)
    witness = max(rel(a, b) for a, b in zip(
        r0["jamba"][str(MR_WITNESS)]["steps"]["grad_norm"],
        one["jamba"]["grad_norm"]))
    jamba_gnorm = max(MT_GNORM_REL, MR_WITNESS_FACTOR * witness)
    gnorm = {"rwkv": None, "jamba": {
        str(s): jamba_gnorm if s != MR_WITNESS else None
        for s in MR_JAMBA_MESHES}}
    rows = {}
    for key in ("rwkv", "jamba"):
        cfg = cfgs[key]
        rows[key] = dict(
            **head, arch=cfg.name, layers=cfg.n_layers,
            block_pattern=list(cfg.block_pattern), batch=list(sizes[key]),
            steps=MR_STEPS, devices=[r["device"] for r in ranks],
            limits=dict(loss_rel=MT_LOSS_REL, gnorm_rel=MT_GNORM_REL,
                        state_rel=MT_STATE_REL),
            one_device=dict(one[key],
                            ms_median=statistics.median(one[key]["ms"])),
            meshes=_mr_meshes(ranks, key, one[key], gnorm[key]))
    rows["jamba"]["witness"] = dict(mesh=list(MR_WITNESS),
                                    gnorm_rel=witness,
                                    factor=MR_WITNESS_FACTOR,
                                    gnorm_limit=jamba_gnorm)
    fault = dict(mesh=list(MR_FAULT), held=_mr_hold(
        r0["fault"]["steps"], one["jamba"], r0["fault"]["held"],
        jamba_gnorm), replicas_equal=all(r["fault"]["replicas_equal"]
                                         for r in ranks))
    rows["jamba"]["fault"] = fault
    save, rest = (r0["rwkv"][str(s)] for s in (MR_SAVE, MR_RESTORE))
    elastic = dict(saved=list(MR_SAVE), restored=list(MR_RESTORE),
                   saved_equal=[r["rwkv"][str(MR_SAVE)]["saved_equal"]
                                for r in ranks],
                   restored_equal=[r["rwkv"][str(MR_RESTORE)]
                                   ["restored_equal"] for r in ranks],
                   save_s=save["save_s"], restore_s=rest["restore_s"])
    smoke = r0["smoke"]
    for key in ("rwkv", "jamba"):
        emit(f"phase10 mesh recurrent {key}", **rows[key])
    emit("phase10 mesh recurrent elastic", **elastic)
    emit("phase10 mesh recurrent smoke", arch=cfgs["smoke"].name,
         layers=cfgs["smoke"].n_layers, batch=list(sizes["smoke"]),
         whole=list(MR_SMOKE_WHOLE), loss_rel_limit=MR_SMOKE_LOSS_REL,
         smoke_equal_across_ranks=all(r["smoke"] == smoke for r in ranks),
         meshes=smoke)
    for key in ("rwkv", "jamba"):
        for shape, m in rows[key]["meshes"].items():
            assert m["local_shapes_ok"] and m["losses_equal_across_ranks"], \
                (key, shape, m)
            assert m["held"]["within"], (key, shape, m["held"])
            assert m["replicas_equal"], (key, shape)
            assert all(n == 0 for n in m["flash_launches_ranks"]), (key, m)
    assert not fault["held"]["within"], fault
    assert all(elastic["saved_equal"]) and all(elastic["restored_equal"]), \
        elastic
    n_attn = cfgs["smoke"].block_pattern.count("attn")
    for shape, m in smoke.items():
        assert m["within"] and m["replicas_equal"], (shape, m)
        assert max(m["loss_rel"]) <= MR_SMOKE_LOSS_REL, (shape, m)
        if head["cards"]:       # the wrappers count launches on a card
            assert m["flash_launches"] == 2 * n_attn * MR_STEPS, (shape, m)
    return smoke[str((2, 2))]["flash_launches"]


# ------------------------------------------------------------------ phase 11

MC_SEAMLESS = "seamless-m4t-medium"
MC_LAYERS = 2           # 2 encoder and 2 decoder layers at full width, the
                        # depth cut as phases 8-10 cut theirs
MC_MESHES = ((2, 2), (1, 4), (4, 1))     # 8, 4 and 16 of 16 heads a rank
MC_SAVE, MC_RESTORE = (2, 2), (1, 4)
MC_FAULT = (1, 4)       # the planted fault's mesh
# The encoder trains through the cross-attention alone, and bf16 summation
# order moves its master by 0.118 of the steps' change on (4, 1), the mesh
# without tensor parallelism (its steps differ from one device's by FSDP's
# bf16 gradient sums alone), past MT_STATE_REL; the tensor-parallel meshes
# read 1.9-2.0 times that and the planted fault 8 times (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §6). So the encoder is held within
# MC_WITNESS_FACTOR times the (4, 1) witness's reading where that is
# larger than MT_STATE_REL; the factor was set after that reading.
MC_WITNESS = (4, 1)
MC_WITNESS_FACTOR = 3
MC_B, MC_S = 4, 512     # tokens a step, over _src_len (3072) frames
MC_VISION = "llama-3.2-vision-90b"
# vision's xattn_mlp layer at full width (64/8 heads, d_ff 28672, 4096
# image tokens) held a rank at a time: its tensor-parallel form against the
# whole layer on the rank's rows
MC_LAYER_B, MC_LAYER_S = 4, 128
MC_LAYER_MESHES = ((2, 2), (1, 4))
MC_LAYER_REL = 2e-2     # bf16: a rel of the output and of every gradient
MC_SMOKE_B, MC_SMOKE_S = 4, 64
MC_SMOKE_WHOLE = (4, 1)  # vision at smoke size: every width whole
MC_SMOKE_MESHES = ((2, 2), (1, 4))
MC_SMOKE_LOSS_REL = 1e-5    # fp32: each step's loss against (4, 1)
MC_SMOKE_STATE_REL = 1e-4   # fp32: params and master against (4, 1)
MC_RANKS_S = 900


def _mc_encoder(tree) -> list:
    """The leaves of a stacked tree's encoder."""
    from repro_torch.tree import leaves
    return leaves(tree["encoder"])


def _mc_cross(tree) -> list:
    """The leaves of a stacked seamless tree's cross-attention and its
    norm."""
    from repro_torch.tree import leaves
    return leaves(tree["blocks"]["0"]["xattn"]) + [tree["blocks"]["0"]["lnx"]]


# seamless's leaves whose master is read alone beside the whole state's
MC_PARTS = {"encoder": _mc_encoder, "cross": _mc_cross}


def _mc_cfg(which: str):
    """seamless-m4t-medium at full width on MC_LAYERS encoder and decoder
    layers; llama-vision at full width (its xattn_mlp layer alone is
    built); or llama-vision at smoke size (5 layers, fp32)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    if which == "seamless":
        return dataclasses.replace(get_config(MC_SEAMLESS),
                                   n_layers=MC_LAYERS, n_enc_layers=MC_LAYERS)
    cfg = get_config(MC_VISION)
    return reduce_for_smoke(cfg) if which == "smoke" else cfg


MC_BATCH = {"seamless": (MC_B, MC_S), "vision": (MC_LAYER_B, MC_LAYER_S),
            "smoke": (MC_SMOKE_B, MC_SMOKE_S)}


@contextlib.contextmanager
def _source_fault():
    """The planted fault: the cross source (seamless's encoder output)
    enters the tensor-parallel cross-attention without ``copy_to``, so
    each model rank keeps the part of its gradient its own heads give and
    the encoder trains on that part. The shapes line up, so nothing
    raises."""
    from repro_torch.models import blocks
    from repro_torch.models.dist import copy_to

    def partial(p, x, src, ctx):
        return blocks._tp_kv_heads(p, ctx), copy_to(x, ctx.mi, "model"), src
    with mock.patch.object(blocks, "_tp_cross_inputs", partial):
        yield


def _mc_layer(cfg, mi, device, B: int, S: int) -> dict:
    """(b) on one rank: llama-vision's xattn_mlp layer at full width, bf16,
    seeded (gate CROSS_GATE), over B x S tokens and ``_src_len`` random
    image rows: the whole layer on the rank's rows (each leaf's gradient
    summed over the data ranks and cut to the rank's block) against its
    tensor-parallel form on the rank's blocks. rel (max |tp - whole| over
    max |whole|) of the output and of the gradients of x, img_x and every
    leaf; flash launches and ms of each form's forward and backward."""
    import math
    from repro_torch.kernels import flash_attention_fwd, reset_launch_counts
    from repro_torch.models.blocks import FwdCtx, apply_layer
    from repro_torch.models.dist import NO_MESH, all_reduce
    from repro_torch.models.model import _use_params, batch_sharding
    from repro_torch.models.params import (_layer_specs, materialize,
                                           shardings, torch_dtype)
    from repro_torch.tree import flatten, tree_map, unflatten
    specs = _layer_specs(cfg, "xattn_mlp",
                         1.0 / math.sqrt(2.0 * cfg.n_layers))
    sh = shardings(specs, mi)
    g = torch.Generator(device=device).manual_seed(SEED + 50)
    whole = materialize(specs, cfg, g, device)
    whole["xattn"]["gate"].fill_(CROSS_GATE)
    dt = torch_dtype(cfg.activation_dtype)
    x, img, w = (torch.randn(shape, generator=g, device=device).to(dt)
                 for shape in ((B, S, cfg.d_model),
                               (B, _src_len(cfg), cfg.d_model),
                               (B, S, cfg.d_model)))
    rows = batch_sharding(x.shape, mi)
    axes = tuple(a for a in rows.axes(0) if mi.size(a) > 1)
    x, img, w = (rows.cut(t).contiguous() for t in (x, img, w))
    names = [".".join(k) for k in _leaf_names(whole)]
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: 0)

    def run(p, tp):
        flat, tdef = flatten(p)
        live = [t.detach().requires_grad_(True) for t in flat]
        xs = [x.clone().requires_grad_(True), img.clone().requires_grad_(True)]
        ctx = FwdCtx(cfg=cfg, mode="prefill", cross_x=xs[1],
                     mi=mi if tp else NO_MESH, tp=tp,
                     grad_axes=axes if tp else ())
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        pl = unflatten(tdef, live)
        if tp:
            pl = _use_params(pl, sh, ctx)
        y, _ = apply_layer("xattn_mlp", pl, xs[0], ctx, None)
        grads = torch.autograd.grad((y.float() * w.float()).sum(),
                                    live + xs)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        n = len(live)
        if not tp:
            g_leaves = [all_reduce(t, mi, axes) for t in grads[:n]]
            grads = flatten(tree_map(lambda t, s_: s_.cut(t).contiguous(),
                                     unflatten(tdef, g_leaves), sh))[0] \
                + list(grads[n:])
        return [y.detach()] + list(grads), ms, flash_attention_fwd.launches

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ref, ms_whole, fl_whole = run(whole, False)
    local = tree_map(lambda t, s_: s_.cut(t).contiguous(), whole, sh)
    got, ms_tp, fl_tp = run(local, True)
    rels = [_rel(a, b) for a, b in zip(got, ref)]
    live = [float(b.float().abs().max()) > 0 for b in ref]
    n = len(names)
    out = dict(mesh=[mi.size("data"), mi.size("model")], rows=B // (
        mi.size("data")), rel_y=rels[0],
        rel_leaves=dict(zip(names, rels[1:n + 1])), rel_x=rels[n + 1],
        rel_img=rels[n + 2], rel_max=max(rels), all_live=all(live),
        ms_whole=ms_whole, ms_tp=ms_tp, flash_whole=fl_whole,
        flash_tp=fl_tp, peak_gib=(torch.cuda.max_memory_allocated(device)
                                  / 2 ** 30 if cuda else None))
    out["within"] = bool(out["rel_max"] <= MC_LAYER_REL and out["all_live"])
    del whole, local, ref, got
    return out


def _leaf_names(tree, pre=()):
    """The key paths of a tree's leaves, in ``repro_torch.tree``'s order
    (a dict's by sorted key)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                               pre + (k,))]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, pre + (str(i),))]
    return [pre]


def _mc_rank(rank: int, port: int, backend: str, tmp: str,
             device_type: str = "cuda", cfgs=None, sizes=None) -> None:
    """One rank of phase 11: seamless-m4t-medium's cut on MC_MESHES,
    MT_STEPS steps each, their state against the one-device steps'
    (``tmp``/seamless), the encoder's and the cross leaves' master alone,
    the replicas, ms a step, peak GiB, flash launches; the (2, 2) state
    saved and restored on (1, 4), bit for bit against the file; the
    planted fault on (1, 4); vision's xattn_mlp layer on MC_LAYER_MESHES
    (``_mc_layer``); vision at smoke size on MC_SMOKE_MESHES against
    MC_SMOKE_WHOLE. ``cfgs`` and ``sizes`` replace ``_mc_cfg`` and MC_BATCH
    (a rehearsal at small size). Results to ``tmp``/rank<r>.pt."""
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import MeshInfo
    from repro_torch.models.dist import axis_rank
    cuda = device_type == "cuda"
    device = (torch.device("cuda", rank if backend == "nccl" else 0)
              if cuda else torch.device("cpu"))
    init_distributed(rank, MESH_WORLD, f"tcp://localhost:{port}",
                     device=device, backend=backend)
    cfgs = cfgs or {k: _mc_cfg(k) for k in MC_BATCH}
    sizes = sizes or MC_BATCH
    tc = _mt_tc()
    res = dict(rank=rank, device=str(device), backend=dist.get_backend(),
               coords={}, seamless={}, layer={})
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = MeshInfo(make_mesh(shape, ("data", "model"),
                                               device=device_type))
            res["coords"][str(shape)] = [axis_rank(meshes[shape], a)
                                         for a in ("data", "model")]
        return meshes[shape]

    def run(shape, variant=contextlib.nullcontext):
        cfg, mi = cfgs["seamless"], mesh(shape)
        sh, stacked = _mz_shards(cfg, mi)
        batches = _mt_batches(cfg, device, *sizes["seamless"])[:MT_STEPS]
        t0 = time.perf_counter()
        with variant():
            params, opt, start, out = _mesh_run(cfg, tc, batches, mi, sh,
                                                device)
        out["run_s"] = time.perf_counter() - t0
        out["held"] = _mesh_held(mi, stacked, params, opt, start,
                                 os.path.join(tmp, "seamless"),
                                 parts=MC_PARTS)
        out["held_s"] = time.perf_counter() - t0 - out["run_s"]
        if variant is contextlib.nullcontext:
            t0 = time.perf_counter()
            out["replicas_equal"] = all(
                _mt_replicas_equal(t, sh, mi)
                for t in (params, opt.master, opt.mu, opt.nu))
            out["replicas_s"] = time.perf_counter() - t0
        return params, opt, stacked, out

    def release():
        if cuda:
            torch.cuda.empty_cache()

    ck = os.path.join(tmp, "ck")
    both = lambda st: {"params": st, "master": st}
    for shape in MC_MESHES:
        params, opt, stacked, out = run(shape)
        state = _mt_ref_state(params, opt)
        if shape == MC_SAVE:
            t0 = time.perf_counter()
            save(ck, MT_STEPS, state, shardings=both(stacked), mi=mesh(shape))
            out["save_s"] = time.perf_counter() - t0
            out["saved_equal"] = _mt_equal_to_file(ck, MT_STEPS, state,
                                                   both(stacked))
        if shape == MC_RESTORE:
            t0 = time.perf_counter()
            got = restore(ck, MT_STEPS, state, shardings=both(stacked))
            out["restore_s"] = time.perf_counter() - t0
            out["restored_equal"] = _mt_equal_to_file(ck, MT_STEPS, got,
                                                      both(stacked))
            del got
        res["seamless"][str(shape)] = out
        del params, opt, state
        release()
    res["fault"] = run(MC_FAULT, _source_fault)[3]
    release()
    t0 = time.perf_counter()
    for shape in MC_LAYER_MESHES:
        res["layer"][str(shape)] = _mc_layer(cfgs["vision"], mesh(shape),
                                             device, *sizes["vision"])
        release()
    res["layer_s"] = time.perf_counter() - t0
    res["smoke"] = _smoke_held(cfgs["smoke"], tc, mesh, device,
                               *sizes["smoke"], MC_SMOKE_WHOLE,
                               MC_SMOKE_MESHES)
    res["smoke_s"] = time.perf_counter() - t0 - res["layer_s"]
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _mc_flash(cfgs: dict, sizes: dict) -> list:
    """Flash at every rank shape phase 11 gives it, against the plain
    version with lse: seamless's causal self-attention, its non-causal
    encoder and its non-causal cross-attention over ``_src_len`` frames on
    each of MC_MESHES; vision's cross-attention over its image tokens in
    the layer case, tensor-parallel and whole on each of MC_LAYER_MESHES
    (bf16); vision's smoke self- and cross-attention on MC_SMOKE_WHOLE and
    MC_SMOKE_MESHES (fp32 D 16)."""
    phase = "phase11 mesh cross flash"
    rows = []
    cfg = cfgs["seamless"]
    B, S = sizes["seamless"]
    src = _src_len(cfg)
    for d, m in MC_MESHES:
        hq, hkv = cfg.n_heads // m, _rank_kv_heads(cfg, m)
        for what, sq, skv, causal in (("self", S, S, True),
                                      ("encoder", src, src, False),
                                      ("cross", S, src, False)):
            rows.append(_flash_row(phase, dict(arch=cfg.name, mesh=[d, m],
                                               what=what), torch.bfloat16,
                                   B // d, sq, skv, hq, hkv, cfg.d_head,
                                   causal))
    cfg = cfgs["vision"]
    B, S = sizes["vision"]
    for d, m in MC_LAYER_MESHES:
        for what, mm in (("cross tp", m), ("cross whole", 1)):
            rows.append(_flash_row(phase, dict(arch=cfg.name, mesh=[d, m],
                                               what=what), torch.bfloat16,
                                   B // d, S, _src_len(cfg),
                                   cfg.n_heads // mm, _rank_kv_heads(cfg, mm),
                                   cfg.d_head, False))
    cfg = cfgs["smoke"]
    B, S = sizes["smoke"]
    for d, m in (MC_SMOKE_WHOLE,) + MC_SMOKE_MESHES:
        hq, hkv = cfg.n_heads // m, _rank_kv_heads(cfg, m)
        for what, skv, causal in (("smoke self", S, True),
                                  ("smoke cross", _src_len(cfg), False)):
            rows.append(_flash_row(phase, dict(arch=cfg.name, mesh=[d, m],
                                               what=what), torch.float32,
                                   B // d, S, skv, hq, hkv, cfg.d_head,
                                   causal))
    return rows


def phase_mesh_cross(device_type: str = "cuda", cfgs=None,
                     sizes=None) -> dict:
    """11. Cross-attention training on a mesh: four ranks as in 8, each
    rank its blocks of every parameter and optimizer buffer (the self-
    and cross-attention's heads, the encoder's, and the MLPs' d_ff over
    model, d over data; the gates whole). Here: flash at every rank shape
    against the plain version with lse (``_mc_flash``); the one-device
    steps of seamless-m4t-medium (full width, 2 encoder and 2 decoder
    layers, bf16, B 4 x 512 over 3072 random frames, every gate
    CROSS_GATE). Then the ranks (``_mc_rank``): three steps on (2, 2), (1,
    4) and (4, 1), each held against the one-device steps (loss 2e-3,
    gradient norm 2e-2, params and master 0.1 of the steps' own change,
    the encoder's and the cross leaves' master 0.1 too); (1, 4) again with
    the encoder output entering the cross-attention without ``copy_to``,
    which must miss on the encoder's leaves; the replicated leaves bit for
    bit; the (2, 2) save restored on (1, 4) bit for bit; llama-vision's
    full-width xattn_mlp layer, tensor-parallel on (2, 2) and (1, 4)
    against the whole layer on each rank's rows (output and every
    gradient within MC_LAYER_REL); vision at smoke size on (2, 2) and (1,
    4) against (4, 1) (loss 1e-5, state MC_SMOKE_STATE_REL); readings: ms
    a step, peak GiB a rank, flash launches. A rank's failure fails the
    phase."""
    import shutil
    import torch.multiprocessing as mp
    card = _card_line()
    cfgs = cfgs or {k: _mc_cfg(k) for k in MC_BATCH}
    sizes = sizes or MC_BATCH
    cuda = device_type == "cuda"
    flash = _mc_flash(cfgs, sizes) if cuda else []
    tc = _mt_tc()
    tmp = tempfile.mkdtemp(prefix=".mesh_cross_", dir=HERE)
    try:
        batches = _mt_batches(cfgs["seamless"], device_type,
                              *sizes["seamless"])[:MT_STEPS]
        one = _mr_one_device(cfgs["seamless"], tc, batches, device_type,
                             os.path.join(tmp, "seamless"))
        del batches
        if cuda:
            torch.cuda.empty_cache()       # the ranks share this card
        n_cards = torch.cuda.device_count() if cuda else 0
        backend = "nccl" if n_cards >= MESH_WORLD else "gloo"
        parent_gib = (torch.cuda.memory_reserved() / 2 ** 30 if cuda
                      else None)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        t0 = time.perf_counter()
        ctx = mp.spawn(_mc_rank, args=(_free_port(), backend, tmp,
                                       device_type, cfgs, sizes),
                       nprocs=MESH_WORLD, join=False)
        while not ctx.join(timeout=5):      # a rank's failure raises here
            if time.perf_counter() - t0 > MC_RANKS_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the ranks ran past {MC_RANKS_S} s")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(MESH_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _mc_check(ranks, one, cfgs, sizes, dict(
        card=card, backend=backend, cards=n_cards, ranks_s=ranks_s,
        parent_reserved_gib=parent_gib))
    return dict(flash=flash, launches=launches)


def _mc_check(ranks, one: dict, cfgs: dict, sizes: dict, head: dict) -> int:
    """Phase 11's rows from the ranks' results, and its gates; returns the
    flash launches of a (2, 2) rank in seamless's steps."""
    r0 = ranks[0]
    cfg = cfgs["seamless"]
    witness = r0["seamless"][str(MC_WITNESS)]["held"]["encoder"]["rel"]
    enc_limit = max(MT_STATE_REL, MC_WITNESS_FACTOR * witness)

    def hold(steps, held, shape: str):
        """_mr_hold with the cross leaves' master as its mixer, and the
        encoder's within ``enc_limit`` (the witness's: not held)."""
        row = _mr_hold(steps, one, dict(held, mixer=held["cross"]))
        row["cross"] = row.pop("mixer")
        row["encoder"] = held["encoder"]
        is_witness = shape == str(MC_WITNESS)
        row["encoder_limit"] = None if is_witness else enc_limit
        row["encoder_within"] = (is_witness
                                 or held["encoder"]["rel"] <= enc_limit)
        row["within"] = bool(row["within"] and row["encoder_within"])
        return row

    meshes, shapes = {}, {str(s): s for s in MC_MESHES}
    for shape, x0 in r0["seamless"].items():
        runs = [r["seamless"][shape] for r in ranks]
        meshes[shape] = dict(
            held=hold(x0["steps"], x0["held"], shape),
            held_equal_across_ranks=all(
                x["held"] == x0["held"] for x in runs),
            loss=x0["steps"]["loss"], grad_norm=x0["steps"]["grad_norm"],
            losses_equal_across_ranks=all(
                x["steps"]["loss"] == x0["steps"]["loss"] for x in runs),
            ms_ranks=[x["steps"]["ms"] for x in runs],
            ms_median=statistics.median(x0["steps"]["ms"]),
            peak_gib_ranks=[x.get("peak_gib") for x in runs],
            embed_used=x0["embed_used"],
            embed_ok=all(_embed_ok(x["embed_used"], _embed_expected(
                cfg, shapes[shape])) for x in runs),
            run_s=x0["run_s"], held_s=x0["held_s"],
            replicas_s=x0["replicas_s"],
            local_shapes_ok=all(x["local_shapes_ok"] for x in runs),
            replicas_equal=all(x["replicas_equal"] for x in runs),
            flash_launches_ranks=[x["flash_launches"] for x in runs])
    fault = r0["fault"]
    fault_row = dict(mesh=list(MC_FAULT), loss=fault["steps"]["loss"],
                     grad_norm=fault["steps"]["grad_norm"],
                     held=hold(fault["steps"], fault["held"],
                               str(MC_FAULT)))
    save, rest = (r0["seamless"][str(s)] for s in (MC_SAVE, MC_RESTORE))
    elastic = dict(saved=list(MC_SAVE), restored=list(MC_RESTORE),
                   saved_equal=[r["seamless"][str(MC_SAVE)]["saved_equal"]
                                for r in ranks],
                   restored_equal=[r["seamless"][str(MC_RESTORE)]
                                   ["restored_equal"] for r in ranks],
                   save_s=save["save_s"], restore_s=rest["restore_s"])
    layer = {shape: [r["layer"][shape] for r in ranks]
             for shape in r0["layer"]}
    smoke = r0["smoke"]
    emit("phase11 mesh cross seamless", **head, arch=cfg.name,
         layers=cfg.n_layers, enc_layers=cfg.n_enc_layers,
         src_len=_src_len(cfg), batch=list(sizes["seamless"]),
         steps=MT_STEPS, devices=[r["device"] for r in ranks],
         cross_gate=CROSS_GATE,
         limits=dict(loss_rel=MT_LOSS_REL, gnorm_rel=MT_GNORM_REL,
                     state_rel=MT_STATE_REL),
         one_device=dict(one, ms_median=statistics.median(one["ms"])),
         witness=dict(mesh=list(MC_WITNESS), encoder_rel=witness,
                      factor=MC_WITNESS_FACTOR, encoder_limit=enc_limit),
         meshes=meshes, fault=fault_row)
    emit("phase11 mesh cross elastic", **elastic)
    emit("phase11 mesh cross vision layer", arch=cfgs["vision"].name,
         batch=list(sizes["vision"]), src_len=_src_len(cfgs["vision"]),
         rel_limit=MC_LAYER_REL, seconds=r0["layer_s"], meshes=layer)
    emit("phase11 mesh cross smoke", arch=cfgs["smoke"].name,
         layers=cfgs["smoke"].n_layers, batch=list(sizes["smoke"]),
         whole=list(MC_SMOKE_WHOLE), loss_rel_limit=MC_SMOKE_LOSS_REL,
         state_rel_limit=MC_SMOKE_STATE_REL, seconds=r0["smoke_s"],
         smoke_equal_across_ranks=all(r["smoke"] == smoke for r in ranks),
         meshes=smoke)
    for shape, m in meshes.items():
        assert m["local_shapes_ok"] and m["losses_equal_across_ranks"], \
            (shape, m)
        assert m["held"]["within"], (shape, m["held"])
        assert m["replicas_equal"], shape
        assert m["embed_ok"], (shape, m["embed_used"])
    assert not fault_row["held"]["encoder_within"], fault_row
    assert all(elastic["saved_equal"]) and all(elastic["restored_equal"]), \
        elastic
    for shape, rows in layer.items():
        assert all(x["within"] for x in rows), (shape, rows)
    for shape, m in smoke.items():
        assert m["within"] and m["replicas_equal"], (shape, m)
        assert max(m["loss_rel"]) <= MC_SMOKE_LOSS_REL, (shape, m)
        assert max(m["params"]["rel"], m["master"]["rel"]) <= \
            MC_SMOKE_STATE_REL, (shape, m)
    if head["cards"]:           # the wrappers count launches on a card
        # a step: each encoder layer's attention once (not rematerialised),
        # each decoder layer's self- and cross-attention in the forward
        # and in the remat recompute
        per_step = cfg.n_enc_layers + 4 * cfg.layer_kinds().count("cross_mlp")
        for shape, m in meshes.items():
            assert all(n == per_step * MT_STEPS
                       for n in m["flash_launches_ranks"]), (shape, m)
        n_smoke = len(cfgs["smoke"].layer_kinds())
        for shape, m in smoke.items():
            assert m["flash_launches"] == 2 * n_smoke * MT_STEPS, (shape, m)
    return meshes[str((2, 2))]["flash_launches_ranks"][0]


# ------------------------------------------------------------------ phase 12

PP_WORLD = 4
# (a): the reference's own case (tests/test_multidevice.py:23-52): W (8,
# 16, 16) at scale 0.3, x (6, 2, 4, 16), a block x -> tanh(x @ w), the loss
# sum(sin(out)); the output within 1e-5, W's gradient within 1e-4
PP_TOY_W, PP_TOY_X = (8, 16, 16), (6, 2, 4, 16)
PP_TOY_OUT_TOL, PP_TOY_GRAD_TOL = 1e-5, 1e-4
# (b): llama3.2-1b's 16 blocks at full width in fp32 (flash's fp32 kernel
# takes D 64), 4 a stage, a batch of 8 x 512 in 4 microbatches of 2 rows
PP_ARCH = "llama3.2-1b"
PP_B, PP_S, PP_MICRO = 8, 512, 4
PP_REL = 1e-4           # the output's and each leaf's max |d| / max |ref|
PP_RANKS_S = 600


def _pp_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(PP_ARCH), param_dtype="float32",
                               activation_dtype="float32")


def _pp_toy_stage(w_loc, x):
    for w in w_loc:
        x = torch.tanh(x @ w)
    return x


def _pp_toy_inputs():
    r = np.random.default_rng(SEED)
    W = (r.standard_normal(PP_TOY_W) * 0.3).astype(np.float32)
    return W, r.standard_normal(PP_TOY_X).astype(np.float32)


def _pp_llama_stage(cfg):
    """apply_stage for llama's blocks: each as the train step applies it
    (a prefill without a cache, flash's autograd Function), no remat."""
    from repro_torch.models.blocks import FwdCtx
    from repro_torch.models.model import _apply_block
    ctx = FwdCtx(cfg=cfg, mode="prefill")

    def apply(blocks, x):
        for p in blocks:
            x = _apply_block(x, p, ctx)
        return x
    return apply


def _pp_leaves(block):
    """A block's parameters as new leaves that need a gradient."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), block)


def _pp_llama(device):
    """(cfg, the 16 blocks, x_micro (4, 2, 512, 2048)), fp32, from SEED:
    the same on every process."""
    from repro_torch.models import init_params
    cfg = _pp_cfg()
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(SEED), device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 12)
    x = torch.randn(PP_MICRO, PP_B // PP_MICRO, PP_S, cfg.d_model,
                    generator=g, device=device)
    return cfg, params["blocks"], x


def _pp_stack_step(stage, blocks, x, want=None) -> tuple:
    """The one-device sequential stack: every microbatch through all the
    blocks, sum(sin(out)) backward a microbatch at a time. Returns (out, the
    gradients of the blocks in ``want`` (default all), ms)."""
    want = range(len(blocks)) if want is None else want
    leaves = {i: _pp_leaves(blocks[i]) for i in want}
    use = [leaves.get(i, b) for i, b in enumerate(blocks)]
    torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    outs = []
    for xi in x:
        y = stage(use, xi)
        torch.sin(y).sum().backward()
        outs.append(y.detach())
    torch.cuda.synchronize(x.device)
    ms = (time.perf_counter() - t0) * 1e3
    grads = {i: [t.grad for t in _leaves(leaves[i])] for i in want}
    return torch.stack(outs), grads, ms


def _pp_rank(rank: int, port: int, backend: str, tmp: str, toy_ref: dict,
             device_type: str = "cuda") -> None:
    """One stage of phase 12: (a) the reference's case, (b) llama's blocks
    twice (the second timed), then the one-device stack for this stage's
    gradients; results to ``tmp``/rank<r>.pt."""
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.pipeline import pipeline_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, rank if backend == "nccl" else 0)
    init_distributed(rank, PP_WORLD, f"tcp://localhost:{port}",
                     device=device, backend=backend)
    mesh = make_mesh((PP_WORLD,), ("stage",), device=device_type)
    res = dict(rank=rank, device=str(device), backend=dist.get_backend())
    # (a)
    W, x = (torch.from_numpy(a).to(device) for a in _pp_toy_inputs())
    per = W.shape[0] // PP_WORLD
    w = W[rank * per:(rank + 1) * per].clone().requires_grad_(True)
    out = pipeline_apply(w, x, _pp_toy_stage, mesh)
    torch.sin(out).sum().backward()
    res["toy"] = dict(
        out_err=(out.detach().cpu() - toy_ref["out"]).abs().max().item(),
        grad_err=(w.grad.cpu() - toy_ref["gW"][rank * per:(rank + 1) * per]
                  ).abs().max().item())
    # (b)
    cfg, blocks, x = _pp_llama(device)
    per = len(blocks) // PP_WORLD
    mine = range(rank * per, (rank + 1) * per)
    stage = _pp_llama_stage(cfg)
    ms, launches = [], []
    for _ in range(2):
        local = [_pp_leaves(blocks[i]) for i in mine]
        dist.barrier()
        reset_launch_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = pipeline_apply(local, x, stage, mesh)
        torch.sin(out).sum().backward()
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(launch_counts()["flash_attention_fwd"])
    res["ms"], res["flash_launches"] = ms, launches
    res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    got = [[t.grad for t in _leaves(b)] for b in local]
    out = out.detach()
    del local
    dist.barrier()          # the pipeline's steps are over on every rank
    ref_out, ref_grads, ref_ms = _pp_stack_step(stage, blocks, x, mine)
    res["stack_ms"] = ref_ms
    res["out_rel"] = _rel(out, ref_out)
    rels = [_rel(a, b) for blk, i in zip(got, mine)
            for a, b in zip(blk, ref_grads[i])]
    res["grad_rel_max"], res["grad_leaves"] = max(rels), len(rels)
    res["grad_rel_min"] = min(rels)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_pipeline(device_type: str = "cuda") -> dict:
    """12. GPipe (``launch/pipeline.py::pipeline_apply``) on a (4,)
    ("stage",) mesh of four ranks (NCCL, one rank a card, with four cards;
    else gloo, the four on cuda:0). Here: the reference's case on one
    device (the sequential stack, its output and W's gradient), and the
    one-device stack of llama3.2-1b's 16 full-width blocks in fp32, timed.
    In the ranks, each a stage of 4 blocks: (a) the reference's case
    against the one-device stack (output 1e-5, the stage's W gradient
    1e-4); (b) llama's blocks, a batch of 8 x 512 in 4 microbatches, one
    forward and backward (sum(sin(out))) twice, the second timed, then the
    one-device stack on the rank: the output and each of the stage's
    leaves' gradients within 1e-4 of their largest value; ms a forward and
    backward beside the one-device stack's, flash launches a rank (4
    blocks x 7 ticks), peak GiB, the bubble fraction (n_stages - 1) / T."""
    import torch.multiprocessing as mp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W, x = (torch.from_numpy(a).to(device_type) for a in _pp_toy_inputs())
    Wg = W.clone().requires_grad_(True)
    out = torch.stack([_pp_toy_stage(Wg, xi) for xi in x])
    torch.sin(out).sum().backward()
    toy_ref = dict(out=out.detach().cpu(), gW=Wg.grad.cpu())
    cfg, blocks, xl = _pp_llama(device_type)
    stage = _pp_llama_stage(cfg)
    stack_ms = [_pp_stack_step(stage, blocks, xl)[2] for _ in range(2)]
    stack_peak = torch.cuda.max_memory_allocated() / 2**30
    del blocks, xl
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= PP_WORLD else "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_pp_rank, args=(_free_port(), backend, tmp, toy_ref,
                                       device_type),
                       nprocs=PP_WORLD, join=False)
        while not ctx.join(timeout=5):      # a rank's failure raises here
            if time.perf_counter() - t0 > PP_RANKS_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the pipeline's ranks ran past "
                                   f"{PP_RANKS_S} s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(PP_WORLD)]
    ticks = PP_MICRO + PP_WORLD - 1
    row = dict(world_size=PP_WORLD, backend=backend, cards=n_cards,
               devices=[r["device"] for r in ranks],
               ranks_s=time.perf_counter() - t0,
               toy=dict(W=list(PP_TOY_W), x=list(PP_TOY_X),
                        out_err=[r["toy"]["out_err"] for r in ranks],
                        grad_err=[r["toy"]["grad_err"] for r in ranks],
                        out_tol=PP_TOY_OUT_TOL, grad_tol=PP_TOY_GRAD_TOL),
               arch=PP_ARCH, dtype="float32", blocks=cfg.n_layers,
               blocks_a_stage=cfg.n_layers // PP_WORLD,
               batch=[PP_B, PP_S], micro=PP_MICRO, ticks=ticks,
               bubble_fraction=(PP_WORLD - 1) / ticks,
               out_rel=[r["out_rel"] for r in ranks],
               grad_rel_max=[r["grad_rel_max"] for r in ranks],
               grad_rel_min=[r["grad_rel_min"] for r in ranks],
               grad_leaves=[r["grad_leaves"] for r in ranks], tol=PP_REL,
               ms_ranks=[r["ms"] for r in ranks],
               one_device_ms=stack_ms,
               stack_on_rank_ms=[r["stack_ms"] for r in ranks],
               flash_launches_ranks=[r["flash_launches"] for r in ranks],
               peak_gib_ranks=[r["peak_gib"] for r in ranks],
               one_device_peak_gib=stack_peak)
    emit("phase12 pipeline", **row)
    assert max(row["toy"]["out_err"]) < PP_TOY_OUT_TOL, row["toy"]
    assert max(row["toy"]["grad_err"]) < PP_TOY_GRAD_TOL, row["toy"]
    assert max(row["out_rel"]) < PP_REL, row["out_rel"]
    assert max(row["grad_rel_max"]) < PP_REL, row["grad_rel_max"]
    want = cfg.n_layers // PP_WORLD * ticks
    assert all(n == [want, want] for n in row["flash_launches_ranks"]), row
    return dict(launches=want, row=row)


# ------------------------------------------------------------------ phase 13

MS_ARCH = "llama3.2-1b"
MS_B, MS_S = 8, 512         # phase 3's eight prompts, right-padded
MS_MAX_LEN, MS_PAGE = 1024, 64
MS_STEPS = 16               # greedy decode steps a mesh
MS_FULL = (1, 4)            # at full depth
MS_CUT = ((2, 2), (4, 1))   # on phase 8's 2-layer cut: FSDP over data
                            # gathers each layer's blocks (and the table)
                            # through the host at every step over gloo
MS_RANKS_S = 600


def _ms_cfg(mesh):
    """The config a mesh serves: full depth on MS_FULL, else the cut."""
    from repro_torch.configs import get_config
    cfg = get_config(MS_ARCH)
    return cfg if tuple(mesh) == MS_FULL else dataclasses.replace(
        cfg, n_layers=MT_LAYERS)


def _ms_params(cfg, device, mi=None):
    """Seeded weights, wq and wk x 0.1 (phase 6's "scaled" set: llama's
    init is chaotic at depth, and the mesh's bf16 sums run in another
    order); on a mesh the rank's blocks of the same tree."""
    from repro_torch.models import NO_MESH, init_params
    g = torch.Generator(device=device).manual_seed(SEED + 40)
    return _qk_scaled(init_params(cfg, g, device, mi=mi or NO_MESH))


def _ms_batch(cfg, device) -> dict:
    """Phase 3's eight prompts (185-481 tokens) right-padded to MS_S."""
    prompts = requests(cfg.vocab_size, np.random.default_rng(SEED))
    tokens = torch.zeros((MS_B, MS_S), dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    return {"tokens": tokens.to(device),
            "lengths": torch.tensor([len(p) for p in prompts],
                                    dtype=torch.int32, device=device)}


def _ms_one_device(cfg, device) -> dict:
    """The one-device steps on the phase's weights: the prefill's logits,
    MS_STEPS greedy decode steps with their logits (the tokens the ranks
    are fed), one more step's logits, each greedy step's ms (a second
    run, sample=True, as the ranks run) and the peak GiB."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import NO_MESH, init_cache
    params = _ms_params(cfg, device)
    batch = _ms_batch(cfg, device)
    prefill = make_prefill_step(cfg, NO_MESH, MS_PAGE)
    decode = make_decode_step(cfg, NO_MESH, page_size=MS_PAGE)
    sample = make_decode_step(cfg, NO_MESH, sample=True, page_size=MS_PAGE)
    torch.cuda.reset_peak_memory_stats()
    cache = init_cache(cfg, MS_B, MS_MAX_LEN, MS_PAGE, device=device)
    lg, cache = prefill(params, batch, cache)
    out = dict(prefill_logits=lg.float().cpu(), tokens=[], margins=[])
    tok, pos = lg.argmax(-1), batch["lengths"].clone()
    for _ in range(MS_STEPS):
        out["tokens"].append(tok.cpu())
        top2 = lg.float().topk(2, -1).values
        out["margins"].append((top2[..., 0] - top2[..., 1]).cpu())
        lg, cache = decode(params, tok, pos, cache)
        tok, pos = lg.argmax(-1), pos + 1
    out["last_token"] = tok.cpu()
    lg, cache = decode(params, tok, pos, cache)
    out["last_logits"] = lg.float().cpu()
    cache = init_cache(cfg, MS_B, MS_MAX_LEN, MS_PAGE, device=device)
    _, cache = prefill(params, batch, cache)
    pos, ms = batch["lengths"].clone(), []
    for t in out["tokens"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = sample(params, t.to(device), pos, cache)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        pos = pos + 1
    out["ms_steps"] = ms
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _ms_decode_row(cfg, mesh, lengths) -> dict:
    """The per-slot decode kernel at a rank's shape on ``mesh``: its rows
    (B / data), every q head (gathered over model), its slice of every
    page (64 / model tokens of all 8 KV heads, 16 pages), the local
    lengths of the last rank of ``model`` at ``lengths`` (the served
    lengths after the last step); with lse where the page splits, as the
    step runs it. Against the plain version, timed, with its bound."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.attention import split_local_lengths
    d, m = mesh
    B, pl, n_pages = MS_B // d, MS_PAGE // m, MS_MAX_LEN // MS_PAGE
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(
        torch.bfloat16)
    q = mk(B, cfg.n_heads, cfg.d_head)
    kp = mk(B, n_pages, pl, cfg.n_kv_heads, cfg.d_head)
    vp = mk(B, n_pages, pl, cfg.n_kv_heads, cfg.d_head)
    tbl = torch.arange(n_pages, dtype=torch.int32, device="cuda") \
        .expand(B, n_pages).contiguous()
    ln = split_local_lengths(lengths[:B].cuda(), n_pages * MS_PAGE, MS_PAGE,
                             m, m - 1).contiguous()
    lse = m > 1
    call = lambda: paged_attention(q, kp, vp, tbl, ln, return_lse=lse)
    plain = lambda: paged_attention_ref(q, kp, vp, tbl, ln, return_lse=lse)
    got, want = call(), plain()
    torch.cuda.synchronize()
    out, ref = (got[0], want[0]) if lse else (got, want)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (got[1] - want[1]).abs().max().item() if lse else None
    row = dict(mesh=list(mesh), shape=[list(q.shape), list(kp.shape)],
               local_lengths=ln.tolist(), return_lse=lse, max_abs_err=err,
               tol=TOL[torch.bfloat16], lse_err=lse_err,
               lse_tol=DECODE_LSE_TOL)
    assert err <= TOL[torch.bfloat16], row
    assert not lse or lse_err <= DECODE_LSE_TOL, row
    nbytes, flops = _slot_decode_bound(q, kp, tbl, ln)
    if lse:
        nbytes += 4 * q.shape[0] * q.shape[1]
    row.update(_decode_times(call, plain, nbytes, flops, torch.bfloat16,
                             plain_iters=3), library_ms=None)
    emit("phase13 mesh serve decode", **row)
    return row


def _ms_rank(rank: int, port: int, backend: str, tmp: str, forced: dict,
             device_type: str = "cuda") -> None:
    """One rank of phase 13: for each mesh, its blocks of the weights and
    of the per-slot cache, their bytes against ``abstract``'s; the
    prefill step, then MS_STEPS greedy decode steps fed the one-device
    run's tokens (``forced``: the rank's argmax beside them), each timed;
    the launches and the peak from 0 just before; then one more step's
    logits. Results to ``tmp``/rank<r>.pt."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.input_specs import prefill_cache_specs
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import MeshInfo, init_cache
    from repro_torch.models.dist import axis_rank
    from repro_torch.models.model import batch_sharding
    from repro_torch.models.params import abstract, model_specs
    from repro_torch.tree import leaves
    device = torch.device(device_type, rank if backend == "nccl" else 0)
    init_distributed(rank, MESH_WORLD, f"tcp://localhost:{port}",
                     device=device, backend=backend)
    res = dict(rank=rank, device=str(device), backend=dist.get_backend())
    for mesh in (MS_FULL,) + MS_CUT:
        mi = MeshInfo(make_mesh(mesh, ("data", "model"), device=device_type))
        cfg = _ms_cfg(mesh)
        params = _ms_params(cfg, device, mi)
        cache = init_cache(cfg, MS_B, MS_MAX_LEN, MS_PAGE, device=device,
                           mi=mi, placed=True)
        torch.cuda.synchronize(device)
        held = leaves(params) + leaves(cache)
        want = (leaves(abstract(model_specs(cfg), mi, cfg=cfg))
                + leaves(prefill_cache_specs(
                    cfg, ShapeConfig("c", MS_MAX_LEN, MS_B, "prefill"), mi,
                    MS_PAGE)[0]))
        r = dict(coords=[axis_rank(mi, a) for a in ("data", "model")],
                 nbytes=sum(t.untyped_storage().nbytes() for t in held),
                 want_nbytes=sum(t.numel() * t.element_size() for t in want),
                 shapes_ok=[list(t.shape) for t in held]
                 == [list(t.shape) for t in want])
        rows = batch_sharding((MS_B,), mi)
        batch = _ms_batch(cfg, device)
        prefill = make_prefill_step(cfg, mi, MS_PAGE)
        sample = make_decode_step(cfg, mi, sample=True, page_size=MS_PAGE)
        decode = make_decode_step(cfg, mi, page_size=MS_PAGE)
        steps = forced[tuple(mesh) == MS_FULL]
        dist.barrier()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        lg, cache = prefill(params, batch, cache)
        torch.cuda.synchronize(device)
        r["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        r["prefill_logits"] = lg.float().cpu()
        pos, toks, ms = batch["lengths"].clone(), [], []
        for t in steps["tokens"]:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            tok, cache = sample(params, t.to(device), pos, cache)
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok.cpu())
            pos = pos + 1
        r["launches"] = launch_counts()
        r["flash_wgmma"] = _serve_launches()["flash_attention_fwd_wgmma"]
        r["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        r["tokens"], r["ms_steps"] = toks, ms
        lg, cache = decode(params, steps["last_token"].to(device), pos, cache)
        r["last_logits"] = lg.float().cpu()
        r["rows"] = [rows.cut(torch.arange(MS_B)).tolist()]
        res[str(tuple(mesh))] = r
        del params, cache
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh_serve(device_type: str = "cuda") -> dict:
    """13. The reference's serve steps on a mesh: four ranks as in 7,
    llama3.2-1b at full width in bf16 (wq, wk x 0.1) through
    ``make_prefill_step`` and ``make_decode_step`` with placed weights and
    cache (each rank its blocks of the parameters, FSDP over data and TP
    over model, and of the per-slot cache, each page's 64 tokens over
    model), phase 3's eight prompts right-padded to 512, a cache of 1024
    tokens at page 64, 16 greedy steps: on (1, 4) at full depth, on (2,
    2) and (4, 1) on phase 8's 2-layer cut. Here: flash and the per-slot
    decode at every rank shape against their plain versions, and the
    one-device steps (logits, the greedy tokens the ranks are fed, ms a
    step). In the ranks: the bytes of their blocks against ``abstract``'s
    prediction, the prefill's logits and one later step's within 5e-2 of
    the one-device steps', the first greedy tokens equal wherever the
    one-device top-2 margin exceeds twice the logits' gap, each step's
    greedy tokens (a reading), replicas bit for bit, ms a step, peak GiB
    and each kernel's launches a rank."""
    import torch.multiprocessing as mp
    from repro_torch.models.model import page_split
    torch.backends.cuda.matmul.allow_tf32 = False
    forced, one = {}, {}
    for full in (True, False):
        mesh = MS_FULL if full else MS_CUT[0]
        cfg = _ms_cfg(mesh)
        one[full] = _ms_one_device(cfg, device_type)
        forced[full] = {k: one[full][k] for k in ("tokens", "last_token")}
        torch.cuda.empty_cache()
    lengths = torch.tensor([len(p) for p in requests(
        _ms_cfg(MS_FULL).vocab_size, np.random.default_rng(SEED))]) + MS_STEPS
    flash_rows, decode_rows = [], []
    for mesh in (MS_FULL,) + MS_CUT:
        cfg = _ms_cfg(mesh)
        d, m = mesh
        flash_rows.append(_flash_row(
            "phase13 mesh serve flash", dict(arch=cfg.name, mesh=list(mesh)),
            torch.bfloat16, MS_B // d, MS_S, MS_S, cfg.n_heads // m,
            _rank_kv_heads(cfg, m), cfg.d_head, True))
        decode_rows.append(_ms_decode_row(cfg, mesh, lengths))
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= MESH_WORLD else "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_ms_rank, args=(_free_port(), backend, tmp, forced,
                                       device_type),
                       nprocs=MESH_WORLD, join=False)
        while not ctx.join(timeout=5):      # a rank's failure raises here
            if time.perf_counter() - t0 > MS_RANKS_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the serve ranks ran past {MS_RANKS_S} s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(MESH_WORLD)]
    ranks_s = time.perf_counter() - t0
    meshes = {}
    for mesh in (MS_FULL,) + MS_CUT:
        cfg = _ms_cfg(mesh)
        ref = one[tuple(mesh) == MS_FULL]
        rs = [r[str(tuple(mesh))] for r in ranks]
        rels, last_rels, firsts, decisive, equal = [], [], [], [], []
        for r in rs:
            idx = r["rows"][0]
            pre = ref["prefill_logits"][idx]
            rels.append(_rel(r["prefill_logits"], pre))
            last_rels.append(_rel(r["last_logits"], ref["last_logits"][idx]))
            gap = (r["prefill_logits"] - pre).abs().max().item()
            ours = r["prefill_logits"].argmax(-1)
            sure = ref["margins"][0][idx] > 2 * gap
            firsts.append((ours == ref["tokens"][0][idx]).sum().item())
            decisive.append(bool((ours == ref["tokens"][0][idx])[sure].all()))
            equal.append(sum((a.cpu() == b[idx]).sum().item() for a, b in
                             zip(r["tokens"][:-1], ref["tokens"][1:])))
        groups = {}
        for r in rs:
            groups.setdefault(r["coords"][0], []).append(r)
        replicas = all(
            torch.equal(a["prefill_logits"], g[0]["prefill_logits"])
            and torch.equal(a["last_logits"], g[0]["last_logits"])
            and all(torch.equal(x, y) for x, y in zip(a["tokens"],
                                                      g[0]["tokens"]))
            for g in groups.values() for a in g[1:])
        L = cfg.n_layers
        want = {"flash_attention_fwd": L, "paged_attention": L * MS_STEPS,
                "paged_attention_global": 0}
        row = dict(
            arch=cfg.name, mesh=list(mesh), layers=L, batch=[MS_B, MS_S],
            max_len=MS_MAX_LEN, page=MS_PAGE,
            page_split=page_split(cfg, MS_PAGE, _placed_stand_in(mesh)),
            steps=MS_STEPS, prefill_rel=rels, last_step_rel=last_rels,
            tol=LOGIT_REL, first_tokens_equal=firsts,
            first_tokens_decisive_equal=decisive,
            greedy_equal_of=[equal, MS_B * (MS_STEPS - 1) // mesh[0]],
            replicas_equal=replicas,
            bytes_ranks=[r["nbytes"] for r in rs],
            bytes_predicted_ranks=[r["want_nbytes"] for r in rs],
            shapes_ok=[r["shapes_ok"] for r in rs],
            prefill_ms_ranks=[r["prefill_ms"] for r in rs],
            ms_a_step_ranks=[statistics.median(r["ms_steps"][1:])
                             for r in rs],
            one_device_ms_a_step=statistics.median(ref["ms_steps"][1:]),
            peak_gib_ranks=[r["peak_gib"] for r in rs],
            one_device_peak_gib=ref["peak_gib"],
            launches_ranks=[{k: r["launches"][k] for k in want} for r in rs],
            flash_wgmma_ranks=[r["flash_wgmma"] for r in rs])
        emit("phase13 mesh serve", **row)
        assert max(rels) < LOGIT_REL and max(last_rels) < LOGIT_REL, row
        assert all(decisive) and replicas, row
        assert all(r["nbytes"] == r["want_nbytes"] and r["shapes_ok"]
                   for r in rs), row
        assert all({k: r["launches"][k] for k in want} == want
                   for r in rs), row
        meshes[str(tuple(mesh))] = row
    emit("phase13 mesh serve ranks", world_size=MESH_WORLD, backend=backend,
         cards=n_cards, devices=[r["device"] for r in ranks],
         ranks_s=ranks_s)
    return dict(flash=flash_rows, decode=decode_rows, meshes=meshes,
                launches={m: r["launches_ranks"][0]
                          for m, r in meshes.items()})


def _placed_stand_in(mesh):
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import MeshInfo
    return MeshInfo(abstract_mesh(mesh, ("data", "model")))


def _precision_fields(row: dict) -> dict:
    """The kernels-line fields of a decode layout's precision row."""
    return {"max_abs_err_cancellation": row["max_abs_err"],
            "max_abs_err_cancellation_p_rounded":
                row["max_abs_err_p_rounded"]}


def _decode_row(t: dict) -> dict:
    """The kernels-line fields of a decode kernel at the serving shape."""
    return {"ms": t["ms"], "device_ms": t["device_ms"],
            "ms_back_to_back": t["ms_back_to_back"],
            "launches_per_call": t["kernel_launches_per_call"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "sdpa_gathered_ms": t["sdpa"]}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also serve the phase-3 requests under "
                         "torch.profiler and print where the time goes")
    ap.add_argument("--decode-only", action="store_true",
                    help="build the decode kernel and run phase 2's decode "
                         "rows only (to time two trees in turns)")
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory instead "
                         "of the script's own src/ (with --decode-only)")
    ap.add_argument("--train-only", action="store_true",
                    help="build the flash kernel and run phase 6 only")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the decode and flash kernels and run phase "
                         "7 (serving on a mesh of four ranks) only")
    ap.add_argument("--mesh-train-only", action="store_true",
                    help="build the flash kernel and run phase 8 "
                         "(training on a mesh of four ranks) only")
    ap.add_argument("--mesh-moe-only", action="store_true",
                    help="build the flash kernel and run phase 9 (MoE "
                         "training on a mesh of four ranks) only")
    ap.add_argument("--mesh-recurrent-only", action="store_true",
                    help="build the flash kernel and run phase 10 "
                         "(recurrent training on a mesh of four ranks) "
                         "only")
    ap.add_argument("--mesh-cross-only", action="store_true",
                    help="build the flash kernel and run phase 11 "
                         "(cross-attention training on a mesh of four "
                         "ranks) only")
    ap.add_argument("--kimi-only", action="store_true",
                    help="build the decode and flash kernels, hold them at "
                         "kimi-k2's head dim 112 and run phase 3i (the "
                         "two-layer kimi-k2 cut) only")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="build the flash kernel and run phase 12 (GPipe "
                         "over four stage ranks) only")
    ap.add_argument("--mesh-serve-only", action="store_true",
                    help="build the decode and flash kernels and run phase "
                         "13 (the serve steps on a mesh of four ranks) "
                         "only")
    args = ap.parse_args(argv)
    if args.src is not None:
        sys.path.insert(0, os.path.abspath(args.src))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if args.decode_only:
        import repro_torch
        emit("decode-only", src=os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__))))
        phase_card(["paged_attention"])
        phase_decode()
        _decode_precision()
        return 0
    if args.train_only:
        phase_card(["flash_attention"])
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_train()
        return 0
    if args.mesh_only:
        phase_card(["paged_attention", "flash_attention"])
        phase_mesh()
        return 0
    if args.mesh_train_only:
        phase_card(["flash_attention"])
        phase_mesh_train()
        return 0
    if args.mesh_moe_only:
        phase_card(["flash_attention"])
        phase_mesh_moe()
        return 0
    if args.mesh_recurrent_only:
        phase_card(["flash_attention"])
        phase_mesh_recurrent()
        return 0
    if args.mesh_cross_only:
        phase_card(["flash_attention"])
        phase_mesh_cross()
        return 0
    if args.kimi_only:
        phase_card(["paged_attention", "flash_attention"])
        torch.backends.cuda.matmul.allow_tf32 = False
        _decode_archs(KIMI_ARCH)
        _flash_cases(head_dim=112)
        _flash_timed(head_dim=112)
        phase_kimi_arch()
        return 0
    if args.pipeline_only:
        phase_card(["flash_attention"])
        phase_pipeline()
        return 0
    if args.mesh_serve_only:
        phase_card(["paged_attention", "flash_attention"])
        phase_mesh_serve()
        return 0
    phase_s = {}            # each phase's wall seconds, the build's too

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0
        return out

    timed("1", phase_card)
    res = timed("2", phase_kernels)
    launches, served, zc_outs, zc_figures = timed("3", phase_serve)
    copy_launches = timed("3c", phase_copy_serve, *served, zc_outs,
                          zc_figures)
    scheduled_launches = timed("3d", phase_scheduled_serve, *served, zc_outs)
    dense_launches = timed("3e", phase_dense_archs, served[1])
    moe_launches = timed("3f", phase_moe_arch)
    recurrent_launches = timed("3g", phase_recurrent_archs)
    cross_launches = timed("3h", phase_cross_archs)
    kimi_launches = timed("3i", phase_kimi_arch)
    if args.profile:
        timed("profile", phase_profile, *served)
    del served              # phase 3's weights: the mesh phases' ranks
                            # share the card with this process
    for arch in CROSS_ARCHS:
        timed("4", phase_cross_check, arch)
    paper = timed("5", phase_paper_kernels)
    sort = timed("5 sort", phase_mergesort)
    train = timed("6", phase_train)
    mesh = timed("7", phase_mesh)
    mesh_train = timed("8", phase_mesh_train)
    mesh_moe = timed("9", phase_mesh_moe)
    mesh_recurrent = timed("10", phase_mesh_recurrent)
    mesh_cross = timed("11", phase_mesh_cross)
    pipeline = timed("12", phase_pipeline)
    mesh_serve = timed("13", phase_mesh_serve)
    emit("phase seconds", **phase_s)
    dec = res[("decode", torch.bfloat16)]
    flash_rows = res["flash_cases"] + res["flash_timed"]
    fl = res["flash_timed"][1]          # bf16 at the serve's shape
    kimi_fl = [r for r in res["flash_timed"] if r["D"] == 112][0]
    slot = res[("slot", torch.bfloat16)]
    kernels = [
        {"name": "paged_attention_global", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:150",
         "launches": launches["paged_attention_global"],
         "max_abs_err": dec["err"],
         "max_abs_err_fp32": res[("decode", torch.float32)]["err"],
         **_precision_fields(res["precision"]["global"]),
         "launches_scheduled": scheduled_launches,
         "launches_dense_archs": {a: n["paged_attention_global"]
                                  for a, n in dense_launches.items()},
         "launches_moe_arch": moe_launches["zero_copy"][
             "paged_attention_global"],
         "launches_recurrent_archs": {
             a: n["paged_attention_global"]
             for a, n in recurrent_launches.items()},
         "launches_cross_archs": {a: n["paged_attention_global"]
                                  for a, n in cross_launches.items()},
         "launches_kimi_arch": kimi_launches["paged_attention_global"],
         **_decode_row(dec),
         "hbm_residency_ms": res[("residency", torch.bfloat16)]["hbm"],
         "smem_residency_ms": res[("residency", torch.bfloat16)]["smem"],
         "long_context": [r for r in res["decode_long"]
                          if r["layout"] == "global"],
         "arch_shapes": [r for r in res["decode_archs"]
                         if r["layout"] == "global"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:102",
         "launches": copy_launches["paged_attention"],
         "launches_dense_archs": {a: n["paged_attention"]
                                  for a, n in dense_launches.items()},
         "launches_moe_arch_copy": moe_launches["copy"]["paged_attention"],
         "launches_recurrent_archs": {a: n["paged_attention"]
                                      for a, n in recurrent_launches.items()},
         "launches_cross_archs": {a: n["paged_attention"]
                                  for a, n in cross_launches.items()},
         "max_abs_err": slot["err"],
         "max_abs_err_fp32": res[("slot", torch.float32)]["err"],
         **_precision_fields(res["precision"]["slot"]),
         **_decode_row(slot),
         "long_context": [r for r in res["decode_long"]
                          if r["layout"] == "slot"],
         "arch_shapes": [r for r in res["decode_archs"]
                         if r["layout"] == "slot"],
         "launches_mesh_a_rank": mesh["launches"]["paged_attention"],
         "launches_mesh_one_device": mesh["one_device"]["paged_attention"],
         "lse_shapes": mesh["lse"],
         "launches_mesh_serve_a_rank": {
             m: n["paged_attention"]
             for m, n in mesh_serve["launches"].items()},
         "mesh_serve_shapes": [{k: r[k] for k in (
             "mesh", "shape", "local_lengths", "return_lse", "max_abs_err",
             "tol", "lse_err", "ms", "device_ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")} for r in mesh_serve["decode"]]},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
         "launches": launches["flash_attention_fwd"],
         "wgmma_launches": launches["flash_attention_fwd_wgmma"],
         "launches_dense_archs": {a: n["flash_attention_fwd"]
                                  for a, n in dense_launches.items()},
         "launches_moe_arch": {m: n["flash_attention_fwd"]
                               for m, n in moe_launches.items()},
         "launches_recurrent_archs": {a: n["flash_attention_fwd"]
                                      for a, n in recurrent_launches.items()},
         "launches_cross_archs": {a: n["flash_attention_fwd"]
                                  for a, n in cross_launches.items()},
         "launches_kimi_arch": kimi_launches["flash_attention_fwd"],
         "kimi_shape": {k: kimi_fl[k] for k in (
             "B", "Sq", "Skv", "Hq", "Hkv", "D", "kernel", "max_abs_err",
             "tol", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by")},
         "launches_pipeline_a_rank": pipeline["launches"],
         "launches_mesh_serve_a_rank": {
             m: n["flash_attention_fwd"]
             for m, n in mesh_serve["launches"].items()},
         "mesh_serve_shapes": [{k: r[k] for k in (
             "arch", "mesh", "dtype", "shape", "max_abs_err", "tol",
             "lse_err", "ms", "ms_lse", "plain_ms", "library_ms", "bound_ms",
             "bound_by")} for r in mesh_serve["flash"]],
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                            if r["dtype"] == str(torch.bfloat16)),
         "max_abs_err_fp32": max(r["max_abs_err"] for r in flash_rows
                                 if r["dtype"] == str(torch.float32)),
         **{k: fl[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")},
         "launches_train": train["launcher"]["flash_launches"],
         "launches_mesh_a_rank": mesh["launches"]["flash_attention_fwd"],
         "launches_train_a_step": train["launcher"]["flash_launches_a_step"],
         "launches_mesh_train_a_rank": mesh_train["launches"],
         "mesh_train_shape": {k: mesh_train["flash"][k] for k in (
             "shape", "max_abs_err", "lse_err", "ms", "ms_lse", "plain_ms",
             "library_ms", "bound_ms", "bound_by")},
         "launches_mesh_moe_a_rank": mesh_moe["launches"],
         "mesh_moe_shape": {k: mesh_moe["flash"][k] for k in (
             "shape", "max_abs_err", "lse_err", "ms", "ms_lse", "plain_ms",
             "library_ms", "bound_ms", "bound_by")},
         "mesh_moe_shapes": [{k: r[k] for k in (
             "arch", "mesh", "dtype", "shape", "max_abs_err", "tol",
             "lse_err", "ms", "ms_lse", "plain_ms", "library_ms", "bound_ms",
             "bound_by")} for r in mesh_moe["shapes"]],
         "launches_mesh_recurrent_a_rank": mesh_recurrent["launches"],
         "mesh_recurrent_shapes": [{k: r[k] for k in (
             "arch", "mesh", "dtype", "shape", "max_abs_err", "tol",
             "lse_err", "ms", "ms_lse", "plain_ms", "library_ms", "bound_ms",
             "bound_by")} for r in mesh_recurrent["flash"]],
         "launches_mesh_cross_a_rank": mesh_cross["launches"],
         "mesh_cross_shapes": [{k: r[k] for k in (
             "arch", "mesh", "what", "dtype", "causal", "shape", "skv",
             "max_abs_err", "tol", "lse_err", "ms", "ms_lse", "plain_ms",
             "library_ms", "bound_ms", "bound_by")}
             for r in mesh_cross["flash"]],
         "train_shape": {k: train["flash"][k] for k in (
             "shape", "max_abs_err", "lse_err", "ms", "ms_lse", "plain_ms",
             "library_ms", "bound_ms", "bound_by", "plain_bwd_ms")},
         "cases": flash_rows},
    ]
    replaces = {"gemm": "src/repro/kernels/gemm/kernel.py:35",
                "gesummv": "src/repro/kernels/gesummv/kernel.py:26",
                "axpy": "src/repro/kernels/axpy/kernel.py:15",
                "heat3d_step": "src/repro/kernels/heat3d/kernel.py:25"}
    for name, where in replaces.items():
        main_row = paper[(name, "h100", torch.bfloat16)]
        rows = [r for (n, _, _), r in paper.items() if n == name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name.split('_')[0]}.cu",
            "replaces": where,
            "launches": sum(r["launches"] for r in rows),
            **{k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
            "size": main_row["size"], "dtype": main_row["dtype"],
            **({"two_mv_ms": main_row["two_mv_ms"]}
               if "two_mv_ms" in main_row else {}),
            **({k: main_row[k] for k in ("kernel", "device_ms",
                                         "ms_back_to_back",
                                         "library_ms_back_to_back")
                if k in main_row}),
            **({"wgmma_launches": sum(r["wgmma_launches"] for r in rows)}
               if name == "gemm" else {}),
            "cases": [{k: r[k] for k in ("sizes", "size", "dtype", "launches",
                                         "kernel", "wgmma_launches",
                                         "max_abs_err", "ms", "device_ms",
                                         "plain_ms",
                                         "library_ms", "two_mv_ms",
                                         "ms_back_to_back",
                                         "library_ms_back_to_back",
                                         "bound_ms", "bound_by") if k in r}
                      for r in rows]})
    kernels += _sort_rows(sort)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
