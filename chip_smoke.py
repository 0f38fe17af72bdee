#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (singa_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:
  1. card    — name and power limit (nvidia-smi), torch's device name/count
  2. build   — compile every kernel of the serving and training paths from
               singa_tpu_torch/csrc (nvcc, sm_90a), and each planted fault
               from a copy of its source in a temporary directory, all in
               parallel; show ptxas's register / shared-memory report
               and any note that it serialised wgmma instructions
  3. kernels — each kernel against its plain PyTorch version on the card,
               over the cases and limits of singa_tpu_torch/kernel_check.py
               (the backward also with a nonzero lse cotangent), and two
               launches of the backward kernels bitwise equal
  4. faults  — each planted fault must fail those limits on its case
  5. slice   — Llama(LlamaConfig.base()).generate() at B=4, P=1024, N=32,
               bf16 weights, captured (a CUDA graph of the prefill and
               one of the decode step, replayed N - 1 times): the flash
               forward must run once per layer per call, as the kernel
               counts its launches on the card, and the tokens must
               equal an eager call's bitwise; prefill logits with the
               kernel vs with its plain version; prefill ms, decode
               ms/token, tokens/s, peak memory, captured beside eager;
               the card's memory as sessions of other prompt lengths
               are added; then a profile of one captured call
  6. serve   — the paged ServeEngine (singa_tpu_torch.serve) over
               Llama(LlamaConfig.base()) with bf16 weights, 8 slots,
               max_len 1024, blocks of 32: its prefill-chunk and decode
               programs captured as CUDA graphs.  16 requests (8 sharing
               a 256-token system prompt), 64 new tokens each, submitted
               at once, then a burst past max_queue (QueueFull); then the
               first wave of 8 again, plain, through a recovery forced by
               decode faults past the retries (and a retried prefill
               fault), and without prefix sharing.  Checks:
               compiled_counts() == (1, 1) after the traffic and after
               the recovery; each rerun's streams bitwise equal to the
               first wave's, as are those of an engine whose block pool
               is cut so that growth preempts; a teacher-forced oracle
               (each request's prompt and tokens through one plain
               causal forward: every engine token's logit within a limit
               of that position's largest), which a planted fault must
               fail: in bf16 one writing decode k/v into the null block,
               in f32 (4 requests, base() cut to 4 layers) one writing
               it one offset late; no
               flash launch on the card, counted from the main engine's
               warm-up to its last rerun, and over the other engines.
               TTFT, prefill chunk and decode tick times, tokens/s,
               prefix hits, memory, one profiled decode tick, and four
               of the prompts through sequential captured generate()
               calls
  7. load    — the open-loop load generator (singa_tpu_torch.tools.loadgen)
               through an engine of the serve phase's shape over base():
               48 Poisson arrivals at 0.8 x the serve phase's closed-wave
               request rate (its tokens/s over 64 tokens a request), 3
               tenants behind 256-token system prompts, suffixes of
               256/384/512 tokens, 32 or 64 new tokens; completed, shed
               and rejected, tokens/s, TTFT p50/p99, no flash launch; the
               serve_load record validated in a temporary store, the
               run's events in a JSONL sink beside it, and the port's
               obsq over both: slo --check exits 0 on the record and 1
               on a planted copy with ttft_p99_ms raised by 10 %, trace
               of one request shows its submission, prefill span and
               tokens in order, diff serve_load gives a row per record
  8. ops     — the serving operator's tools (singa_tpu_torch.tools:
               loadgen, chaosd, autotune) at base() width cut to 2
               layers: the committed best-config table
               (singa_tpu_torch/autotune/data/best.json) validated with
               the records it cites and resolved for the phase's models,
               each swept knob from a cuda entry naming the card; the
               load driver's spec, spill, disagg and mp smokes in f32
               (streams bitwise against generate() and a single engine,
               the mp smoke across two worker processes); a
               --spec-compare pair (plain against spec_k=3, bf16, the
               table's arena knobs, both serve_load records validated);
               a load run's perf_attr payload (the attribution ledger's
               dispatch times joined against each program's recorded
               FLOPs and bytes) validated, its attributed_frac printed;
               the chaos smoke (one SIGKILL and one SIGSTOP against a
               1:1 process tier, bf16: streams bitwise, no orphan,
               programs within (1, 1), detection and respawn seconds;
               it and the mp smoke run in interpreters of their own,
               started before this phase and read after phase beam, as
               the line of phase ops with "beside" and the wall
               "ops_procs");
               the table's best serve point measured afresh beside its
               recorded tokens/s (not a gate); and its best train point
               (DistOpt over an NCCL group of one, T=1024, 8 timed
               replays) with its flash launches counted on the card
  9. spec    — speculative decoding on the serve engine (spec_k=3), over
               the serve phase's first wave: self-speculation
               (draft_model = the target), a disagreeing draft
               (base() cut to 2 layers, seed 1), a serve.verify fault
               past the retries (one plain-decode fallback tick) and a
               recovery mid-wave; each run's streams held bitwise to
               the plain engine's.  spec_compiled_counts() is
               (1, 0, 1, 0), (1, 1, 1, 0) after the fallback.  Accept
               rate, tokens per dispatch, verify round ms, tokens/s and
               TTFT beside the plain engine's; no flash launch
 10. mem     — the int8 arena and the bf16 one at the serve arena's
               bytes over 24 slots (the 16 prompts and 8 again, no
               prefix sharing, 16 new tokens each): peak concurrency,
               tokens/s, TTFT, tick; the referee (an int8 draft arena
               under the bf16 target) whose accept rate must reach a
               limit that a planted scatter dropping the scales must
               not; quantize_kv on the card equal to the CPU's; the
               spill tier on a 96-block pool (4 system-prompt requests,
               the 8 private prompts, 4 more system-prompt requests):
               the system prompt's blocks spilled and restored by one
               restore program, the third wave's streams equal to an
               engine without the tier's, which a planted restore into
               the next block must break; no flash launch
 11. disagg  — the disaggregated tier in one process: build_pools(1
               prefill, 2 decode) of the serve phase's engine (8 slots,
               1024, blocks of 32, bf16, prefix sharing) behind a
               Router, from one warmed template engine's weight copy.
               The serve phase's 16 prompts x 64 tokens: streams bitwise
               the serve phase's; every worker's compiled_counts() within
               (1, 1), the prefill worker's handoff program made once;
               one weight copy (the same data_ptrs); 16 handoffs, the
               system prompt's blocks mapped copy-free on the decode
               workers (counted).  The first wave again through a
               serve.handoff fault (re-routed) and with a decode worker
               killed mid-flight (replayed), and through a
               self-speculative tier (spec_k=3) whose packages carry the
               draft's KV; each bitwise.  No flash launch.  Tokens/s and
               TTFT beside the serve phase's; the handoff program, the
               package copy and the inject timed; bytes per package,
               pool bytes per worker, peak memory
 12. net     — the process tier: build_proc_pools(1 prefill, 1 decode)
               of worker processes on the card, each building base()
               from chip_smoke:tier_model (the slice phase's weights),
               behind a ProcRouter.  The first wave: streams bitwise the
               serve phase's, cold and warm; a torn frame
               (serve.transport torn_frame) refused by its digest and
               replayed; a decode worker killed mid-flight replayed,
               then respawned and adopted.  Each worker's ready and
               warm-up tick seconds, frame bytes, wire ms, tokens/s
 13. beam    — generate_beam on two of the slice phase's prompts (P=1024,
               N=32, 4 beams, bf16 weights), without and with an eos id:
               the captured session (prefill graph, one beam tick
               replayed N times) against the eager search bitwise, 16
               flash launches per call counted on the card, num_beams=1
               against greedy generate(), the scores against a
               teacher-forced f32 forward; call and tick ms, pool bytes
 14. train   — LlamaConfig.base() (fused loss) with SGD(lr=0.01,
               momentum=0.9): set_optimizer, compile, train_step at B=8 x
               T=1024.  One step's loss and gradients with the kernels vs
               with their plain versions, and with planted faults in
               place of the kernels, eagerly; then through a captured
               step (lr 0), sound and with one backward fault, each
               captured afresh.  From the same initial weights, 4 steps
               eager and 4 captured on four batches, losses held to each
               other; eager steps timed and one profiled; then 10 timed
               replays on a fixed batch: the forward, dQ and dK/dV
               kernels must each run once per layer per step, as they
               count their launches on the card; losses
               finite and falling; step ms, tokens/s, MFU, peak memory,
               capture seconds and the graph's ops and pool bytes; then
               a profile of one replay
 15. checkpoint — LlamaConfig.base() cut to 2 layers: 6 captured steps
               with a save after step 2; a fresh model loads it and runs
               steps 3-6 (eager, warm-up, capture, replay), whose losses
               must equal the uninterrupted run's within the train limit
 16. banded — mistral-w4096 (Mistral-7B-v0.1's widths, sliding window
               4096, cut to 4 layers; singa_tpu_torch/tools/loadgen.py
               holds the configuration): training at B=1 x T=8192 (fused
               loss, SGD momentum), all three kernels banded, 5 eager and
               5 captured steps from the same weights held bitwise in
               losses and parameters (the
               captured run's warm-up call under set_sync_debug_mode
               "error"), 10 timed replays with 4 launches of each kernel
               a step counted on the card, MFU with the window term;
               generate() at B=1, P=8192, N=32 (bf16; banded prefill, 4
               forward launches a call, captured = eager bitwise); the
               paged engine (4 slots, max_len 8192, blocks of 32) over 8
               prompts of 4608-7936 tokens x 32 tokens: tokens/s, TTFT,
               tick, (1, 1) programs, no flash launch, the streams beside
               generate()'s and both held by the teacher-forced bf16 gate
 17. moe    — mixtral-8x7b (Mixtral-8x7B-v0.1's widths, 8 experts,
               top-2, dropless capacity factor 4.0, cut to 1 layer): the
               same at training B=4 x T=1024 (the aux loss read at every
               step, the experts' rows over the active ones),
               generate() at B=4, P=1024, N=32, and the serve phase's
               engine shape over its 16 prompts x 64 tokens; then the
               load generator through that engine, as in phase 7; then
               the engine and generate() rerun eagerly with their expert
               choices traced: the bf16 engine's teacher-forced gaps held
               to the bf16 gate where its routing agreed with the
               forward's, where the streams part the routing and logit
               margins, and a probe of whether a token's expert rows
               depend on the rows beside it at each size the paths run;
               the engine in f32 held by the f32 oracle
 18. cnn    — the vision zoo through compile/train_step: ImageNet
               ResNet-50 (224², 1,000 classes) and CIFAR ResNet-18 (32²),
               each at B=256, bf16 activations over f32 masters,
               SGD(0.1, momentum 0.9, weight decay 1e-4), random images
               from a seed.  5 steps of a second model from the same seed
               eagerly and 5 captured, under deterministic cuDNN, held
               bitwise in losses and every state (BatchNorm's running
               statistics included); then eager steps and a fresh capture
               with 20 timed replays: step ms, images/s, MFU (3 x the
               counted forward FLOPs beside the published 8.18 GFLOP an
               image), peak memory, graph pool bytes.  ResNet-50 also: the
               bytes saved for the backward an image, the card's f32
               step (TF32 off) at B=8 against the port on the
               CPU with the same weights, a captured eval equal to an eager
               one bitwise, a profile of one replay by kind (convolution,
               layout transposes, copies and casts, other), and no
               activation-sized layout copy in an eager step.  Then
               tools/train_cnn.py: one epoch of the synthetic MNIST CNN and
               CIFAR VGG-11, each evaluating through its captured eval
               step.  No flash kernel runs on the path
 19. native  — the native core (singa_tpu_torch._core over the port's copy
               of the C++ runtime, singa_tpu_torch/csrc/core) on the
               card's host: the library built by g++ from the checkout
               (seconds, version, timed alone), then its test binary
               under ASan and UBSan on a thread beside the untimed
               set-up and joined before anything else is timed (not run
               where g++ links no sanitizer; a build or run that raises
               fails the phase).  Three eager MLP steps through
               create_cpu_device(use_native=True) against
               use_native=False (1e-4 / 1e-5, host kernels called and
               not).  Phase cnn's CIFAR ResNet-18 cell, built from its
               seed and captured: schedule()'s node count, the order held
               against the traced graph's dependencies, the arena beside
               the capture's pool.  Phase cnn's ResNet-50 cell, built from
               its seed and captured, fed by DataLoader(use_native=True,
               workers=4, prefetch=4) through prefetch_to_device over 768
               images at 224² labelled arange(768) (three batches an
               epoch), two epochs with the loss read every step, every
               batch's rows equal to x[labels] on the card and every label
               once an epoch; the same through the numpy pipeline; beside
               them the replay alone on a batch already on the card.  Of
               each pipeline: every step's wall ms and batch wait, the
               epoch-first steps (which pull the whole epoch), and
               images/s over the whole window.  No flash kernel runs
 20. transformer — GPT-2 124M (GPT2Config(): published widths and 12
               layers, dropout 0.1) and BERT-base (BERTConfig(num_labels=2)),
               random weights from seed 0, bf16 activations over f32
               masters.  GPT-2: generate() at B=4, P=512, N=32 (captured =
               eager bitwise, 12 forward launches a call counted on the
               card); the paged engine (8 slots, 1024, blocks of 32, bf16)
               over 16 prompts of 128-640 tokens x 64 tokens ((1, 1)
               programs, no flash launch, the bf16 teacher-forced gate; an
               f32 engine's streams equal f32 generate()'s and pass the f32
               oracle); training at B=8 x T=1024 (fused loss, SGD 0.01 /
               momentum 0.9): the step with the kernels against the plain
               versions at the train phase's limits, 5 eager and 5
               captured steps bitwise in losses and parameters, 10 timed
               replays with 12 launches of each kernel a step, the graph's
               own FLOPs as hfu_graph, and MFU from them less the fused
               loss's recomputed head plus the flash kernels' causal
               FLOPs, a profile of one replay; then GPT-2 with
               remat=True beside it, its parameters loaded by name: one
               eager step's loss and gradients and 4 steps (two
               captured) bitwise the plain model's, with the dropout
               generator's state; 24 forward, 12 dQ and 12 dK/dV
               launches a remat step counted on the card; step ms of
               10 alternating replays, the eager step's peak memory and
               the graph pools of both.  BERT
               at bench.py's cell, B=256 x T=128, SGD 0.01 / momentum 0.9:
               5 eager and 5 captured steps bitwise in losses and
               parameters, 10 timed replays (samples/s, MFU from
               flops_per_token), a profile of one replay; an eval with a
               padding mask captured = eager bitwise and blind to the
               padded ids; the f32 eval against the port on the CPU; no
               flash launch anywhere on BERT's path (T = 128 takes the
               plain attention, as in the reference)
 21. hf      — the Llama family through the HuggingFace layout and back on
               the card, without transformers: the slice phase's base()
               (parked on the host since the beam phase), mistral-w4096
               cut to 2 layers and mixtral-8x7b cut to 1, each exported
               by models.hf_layout (the Mixtral layout written here:
               w1 gate, w3 up, w2 down, gate.weight the router) and
               imported by from_hf_llama / from_hf_mistral /
               from_hf_mixtral: parameters and configuration equal,
               logits on one seeded (1, 1024) batch bitwise, greedy
               generate() at B=1, P=1024, N=16 (bf16) equal streams,
               the flash forward once a layer a call counted on the
               card; the imported mistral and its source 3 eager steps
               each at B=1 x T=8192 (SGD 0.01 / momentum 0.9, all three
               kernels banded) bitwise in losses and parameters; the
               export's and the import's host seconds, the process's
               peak RSS and the card's peak memory
 22. tensor  — every function of singa_tpu_torch.tensor once on
               create_device("auto") at (4096, 2048) f32 against numpy,
               with the count that agreed
 23. train_run — fault-tolerant training runs through singa_tpu_torch.train:
               GPT-2 124M's widths (GPT2Config() cut to 4 layers, fused
               loss, dropout 0.1, seed 0) with AdamW(3e-4, weight decay
               0.1) at B=8 x T=1024, a DataLoader over 512 synthetic
               sequences, 24 steps, AsyncCheckpointManager(save_every=8,
               keep_last=2, keep_every=16) in a temporary directory.
               U, uninterrupted, here: losses, a sha256 of the final
               parameters, moments, counter and generator
               states, commits, 4 launches of each kernel a step
               counted on the card, replay and run step ms, snapshot
               and write times, write spans overlapping step spans;
               windowed_steps within 5 % of the median of 12 replays
               timed beside it as U's are (U's own replay medians, all
               and with no write in flight, reported), a device_trace,
               MFU.  Then child interpreters (importing
               chip_smoke:train_run_model by name), three at once: P
               SIGTERMed after 10 steps (checkpoint at its step, exit),
               T+K (the step-16 commit torn after its marker, then
               SIGKILLed between the step-24 file's rename and its
               marker: ckpt_fsck must flag the torn file as an error and
               the other as uncommitted) and H (a hang under
               step_timeout 2 s: exit 42 within 4 s, a "hung" record and
               a flight dump); then P's and T+K's resumes at once,
               beside R here (a retried step, then retries exhausted:
               the emergency checkpoint's pre-draw cursor, an "aborted"
               record, TrainAborted, and a resume).  Every resume
               bitwise U's in losses and final sha256
 24. sonnx   — the ONNX path (singa_tpu_torch.sonnx).  BERT-base at
               bench.py's cell (BERTConfig(num_labels=2), seed 0, B=256 x
               T=128): exported by the port (to_onnx), serialised and
               parsed back (bytes, export / serialise / parse seconds),
               checked (check_model) and imported on the card (prepare);
               its eval logits against the native model's on the export's
               batch, in bf16 (the bf16 gate) and in f32 (SONNX_F32_LOGIT),
               which an import of the parsed proto with one LayerNorm
               gamma scaled by 1.01 must fail; then trained through
               set_optimizer / set_loss / compile / train_step (SGD 0.01
               / momentum 0.9, softmax_cross_entropy): 5 eager and 5
               captured steps bitwise in losses and parameters, 10 timed
               replays (step ms, samples/s, MFU from the native model's
               flops_per_token(128)) beside the transformer phase's
               native step, a profile of one replay by kind.  GPT-2 124M
               (GPT2Config(), seed 0) exported (its tied head one shared
               initializer) and imported for inference at B=8 x T=128:
               logits in bf16 and f32 against the native forward, a
               captured eval bitwise the eager one, ms a call and
               tokens/s of each.  No flash launch on either path, counted
               on the card
 25. rnn     — the char-rnn (tools/train_rnn.CharRNN: two LSTMs of 128
               over an embedding of 64, the reference example's
               widths), B=64 x T=64 characters, Adam 3e-3, bf16
               activations: 40 eager and 40 captured steps bitwise in
               losses and parameters, the loss falling, chars/s of the
               replays; exported (two LSTM nodes), parsed back and
               imported on the card, eval logits against the native
               model's in bf16 and f32; then tools/train_rnn at its
               defaults (150 steps, a sample).  No flash launch
 26. dist    — data-parallel training over NCCL at a world of 1 (the
               machine has one card): parallel.init_distributed on a
               free local port, the data mesh set, the group destroyed
               at the end.  base()'s training cell cut to DIST_LAYERS
               blocks (B=8 x T=1024, fused loss, SGD 0.01 / 0.9) through
               DistOpt in three modes:
               plain, compression="int8_ring" and shard_weight_update
               (ZeRO-1), each as the train phase's step is driven: 5
               eager and 5 captured steps bitwise in losses and
               parameters, 10 timed replays with DIST_LAYERS launches
               of each flash kernel a step counted on the card, step ms,
               tokens/s, MFU and peak memory beside phase train's; one
               eager step's grad_sync ms (an obs.attr ledger) and ms; the
               int8 ring's residual of one parameter after its first
               step bitwise g - dequant(quant(g)); the plain DistOpt
               steps bitwise those of the base optimizer.  ResNet-50 at
               phase cnn's cell through DistOpt (captured = eager
               bitwise, timed replays beside phase cnn's) and through
               tools/train_cnn --dist (one epoch of 2,048 synthetic
               images, 8 steps, the step captured); no
               flash launch there.  No allreduce bandwidth: one rank
               moves nothing between cards
 27. spmd    — tensor and sequence parallelism at a world of 1: base()
               (fused loss) under make_mesh({'data': 1, 'model': 1,
               'seq': 1}), every Linear and embedding in its Megatron
               form, captured, held bitwise to the plain step and timed
               beside it; ring attention's per-rank body over S = 2 and 4
               shards of one card (kernel_check.RING_CASES) against the
               whole-sequence attention, its planted faults caught
 28. pipe    — pipeline and expert parallelism on one card: base()'s 16
               blocks through the per-rank GPipe body of S = 2 and 4
               stages over M = S and 2S microbatches with an in-process
               hop (kernel_check.PIPE_CASES), bf16 and f32, against the
               blocks in order, 16·M launches of each flash kernel, each
               planted pipe fault caught, the schedule timed beside the
               blocks in order; the planner (parallel.planner) for base()
               at a world of 1 against the bytes a captured step holds,
               and llama3_8b's plan on data 4 x model 8; Mixtral-8x7B's
               MoE layer at published widths over 2 and 4 in-process
               expert ranks against the one-device scatter path
 29. timing  — each kernel, its plain version and the PyTorch call that
               computes the same function (scaled_dot_product_attention
               and its gradient: yardsticks the port never calls) at the
               training shapes of base() and GPT-2, beside the card's
               bound, each kernel also held against its plain version on
               the timed inputs; the forward also at base()'s prefill
               shape and at BERT-base's (B=256, T=128, not causal).  The
               kernels' calls are timed as CUDA-graph replays (device
               time: one call can take
               less time on the card than its wrapper takes on the host),
               with back-to-back event timing and the wrapper's host time
               per call reported beside; then the three kernels at
               mistral-w4096's attention shape (H=32, T=8192, W=4096),
               their bound counting the in-band pairs, their plain
               versions over eight heads at a time, and SDPA with the
               band as a boolean mask
The phases run in this order, but for three parts that run in
interpreters of their own beside others, so that their process starts
and waits overlap work: phase ops's mp and chaos smokes (started before
phase ops, read after phase beam) and phase net (started after phase
disagg, read after phase tensor); phases hf, checkpoint and tensor run
right after phase beam, before phase train.  The phase walls
"ops_procs" and "net" are the waits for them.
Then a line with the script's seconds, one {"kernels": [...]} line and,
last, the device line.  Every launch count of the main paths is read
from the counters the kernels advance on the card
(flash_attention.device_launches), so replays of CUDA graphs are counted
as they run.

Weights and inputs are random, drawn from fixed seeds.  The script needs
the repository beside it and a CUDA card; without either it fails.
Phase dist binds a TCP store to a free port of 127.0.0.1.  It
writes one checkpoint under build/ and removes it; phase train_run
writes its checkpoints in a temporary directory and removes it, and
reaps every child it starts, as the parts run beside others are reaped;
every record it makes goes to a temporary store.
"""

import dataclasses
import gc
import io
import json
import math
import os
import resource
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import (contextmanager, nullcontext, redirect_stderr,
                        redirect_stdout)
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense): the bound a kernel is held to
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# last-position prefill logits, kernel vs plain version, relative to the
# largest logit: sixteen bf16 layers, each rounding at 2^-8, amplify a
# one-ulp difference in attention output to a few percent at most
LOGIT_RTOL = 5e-2

B, P, N = 4, 1024, 32
# the prompt lengths of the sessions added to show the card's memory
SESSION_PROMPTS = (256, 512, 768)

# training: B=8 x T=1024 token ids, 2 warm-up steps then 10 timed ones
TB, TT = 8, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# the parameters whose gradients are held kernel vs plain
GRAD_NAMES = ("tok_emb.table", "blocks.0.attn.q_proj.W",
              "blocks.15.attn.k_proj.W", "lm_head.W")
# one step's loss and those gradients with the kernels vs with their
# plain versions, relative (gradients by Frobenius norm).  Readings
# (PERF.md): loss 3.6e-6, gradients 0.93e-2 to 1.97e-2 -- bf16 roundings
# that fall the other way in 16 layers of activations, as LOGIT_RTOL.
# With a planted fault in place of a kernel: loss 1.35e-4 (forward
# faults only; the backward does not move the loss), the largest
# gradient 0.168 at the weakest fault
TRAIN_LOSS_RTOL = 2e-5
TRAIN_GRAD_RTOL = 5e-2
# planted faults (kernel_check) run through the same step, each of which
# must fail the limits above (the window fault is left out: base() has
# no window)
TRAIN_FAULTS = ("pv_swapped_v_rows", "pv_drops_late_keys",
                "ring_reads_next_stage", "dq_drops_delta",
                "dkv_skips_last_head", "dkv_causal_strict",
                "dq_ring_reads_next_stage", "dkv_reads_next_stage_rows")
# the fault also run through a captured step (the weakest backward
# fault through the eager step: PERF.md)
CAPTURED_FAULT = "dkv_causal_strict"
# steps from the same initial weights, eager and captured, held to each
# other by TRAIN_LOSS_RTOL; eager steps timed after them
COMPARE_STEPS, EAGER_TIMED = 4, 5
# the name phase train gives its model for the captured run: its
# model.train_step spans carry it, its step graph is f"{NAMED_MODEL}.train"
NAMED_MODEL = "m21"
# the checkpoint phase: depth cut so the file stays under 2 GB
CKPT_LAYERS, CKPT_SAVE_AFTER, CKPT_STEPS = 2, 2, 6

# the serve phase: ServeEngine(num_slots, max_len, block_size) over
# LlamaConfig.base() with bf16 weights; 16 requests, half of them behind
# one system prompt, max_new_tokens each
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_BLOCK = 8, 1024, 32
SERVE_REQUESTS, SERVE_SYSTEM, SERVE_NEW = 16, 256, 64
# the block pool of the preemption run: enough for the largest request,
# too few for the first wave of eight to grow (with these prompts, 88 to
# 94 blocks preempt one request)
SERVE_PREEMPT_BLOCKS = 92
# teacher-forced oracle: at every generated position the engine's token
# logit must be within SERVE_DELTA of the plain forward's largest logit.
# Held on an engine computing in f32 over SERVE_ORACLE requests: with
# random weights the logits lie close together, and in bf16 a sound
# engine's gaps and those of the planted scatter fault overlap
# (PERF.md, section 6).  The bf16 engine's gaps are held to
# SERVE_BF16_GAP, four bf16 steps of its logits: a sound engine reads
# 0.0156, one writing every decode token's k/v into the null block 0.242
SERVE_ORACLE = 4
SERVE_DELTA = 1e-3
# the f32 oracle's engine runs base() cut to this depth, at full width:
# it reads the engine's scatter and gather, which depth does not change,
# and the whole script stays near its time budget
SERVE_ORACLE_LAYERS = 4
SERVE_BF16_GAP = 0.0625

# the spec phase: a verify window of SPEC_K proposals; the disagreeing
# draft is LlamaConfig.base() cut to SPEC_DRAFT_LAYERS layers, seed 1
SPEC_K, SPEC_DRAFT_LAYERS = 3, 2
# the mem phase: the int8 and bf16 arenas at the serve arena's bytes
# serve the 16 prompts and 8 of them again over INT8_SLOTS slots without
# prefix sharing, so demand (~410 blocks) exceeds the bf16 arena's
# capacity (256 blocks) and not the int8 one's (511): with sharing the
# bf16 arena held all 16 requests at once, as the int8 one did
# (PERF.md, section 4).  These runs and the spill waves take MEM_NEW new
# tokens a request (they read admission and prefill: concurrency, TTFT,
# restores)
INT8_SLOTS, MEM_NEW = 24, 16
# the referee (an int8 draft arena under the bf16 target, self-
# speculation): a sound arena's accept rate must reach this, the planted
# scatter that drops the scales must not.  Readings on an H100 (PERF.md,
# section 5): sound 0.926, scales dropped 0.528
REFEREE_MIN_ACCEPT = 0.75
# the spill run: a pool too small to keep the system prompt's blocks
# while the 8 private prompts run, and the host store's capacity
SPILL_POOL, SPILL_STORE = 96, 256
# the disagg and net phases: the tiers' pools (prefill, decode workers);
# the in-process tier's handoff fault fires at this handoff, the kill
# comes after this many tier rounds, and a worker process has this long
# to build base() and report ready
DISAGG_POOLS, NET_POOLS = (1, 2), (1, 1)
DISAGG_FAULT_AT, TIER_KILL_AFTER = 3, 4
NET_SPAWN_TIMEOUT_S = 300.0
# the beam phase: two of the slice phase's prompts, four beams, and the
# returned scores against a teacher-forced f32 forward, relative: the
# search runs bf16 weights and activations, each of 32 log-softmax
# terms off by bf16 roundings of the logits
BEAM_B, BEAM_K, BEAM_N = 2, 4, 32
BEAM_SCORE_RTOL = 1e-2
# the load phase (singa_tpu_torch.tools.loadgen): LOAD_REQUESTS Poisson
# arrivals at LOAD_RATE_SHARE of the closed wave's request rate on the
# same engine, of the load driver's chat traffic (loadgen.CHAT_WORKLOAD:
# 3 tenants behind 256-token system prompts, suffixes of 256/384/512
# tokens, 32 or 64 new tokens), from seed LOAD_SEED
LOAD_REQUESTS, LOAD_RATE_SHARE, LOAD_SEED = 48, 0.8, 0
# phase ops's mp and chaos smokes (OpsProcs): how long after phase beam
# they may still take
OPS_PROCS_TIMEOUT_S = 600.0
# the planted copy of the load record that obsq slo --check must refuse:
# its ttft_p99_ms raised by this share (obsq's tolerance is 1 %)
LOAD_PLANT = 0.10
# the ops phase: the autotuner's card sweep model (tools/autotune.py
# CARD_SWEEP: base() cut to 2 layers, seed 0; the best-config table's
# serve/llama-d2048-L2/cuda and train/llama-d2048-L2-dp1/cuda entries),
# under whose workload the table's best serve point is measured afresh
# and the best train point is run; OPS_PAIR is the --spec-compare
# pair's and the perf_attr load run's workload
OPS_PAIR = dict(requests=16, rate=1000.0, trials=3, max_len=384,
                prompt_lens=(64, 128), new_tokens=(32,))
# the banded and moe phases: two published configurations
# (singa_tpu_torch/models/llama.py PUBLISHED: mistral-w4096 from
# Mistral-7B-v0.1's config.json, mixtral-8x7b from Mixtral-8x7B-v0.1's)
# at their widths, cut in depth only, random weights from seed 0.
# Training (B, T) with
# the fused loss; generate() (B, P, N); CONFIG_STEPS eager and captured
# steps held bitwise (here and in the transformer phase)
# mixtral-8x7b at 1 of its 32 layers: the script's wall budget
BANDED_LAYERS, MOE_LAYERS = 4, 1
BANDED_TRAIN, MOE_TRAIN = (1, 8192), (4, 1024)
BANDED_GEN, MOE_GEN = (1, 8192, 32), (4, 1024, 32)
CONFIG_STEPS = 5
# the banded engine: (slots, max_len, block_size, requests, new tokens),
# its prompts of BANDED_PROMPTS tokens (all past the window), seed
# BANDED_SEED; the moe engine is the serve phase's, over its prompts
BANDED_SERVE = (4, 8192, 32, 8, 32)
BANDED_PROMPTS, BANDED_SEED = (4608, 7936), 6
# the timing phase's long window: mistral-w4096's attention at its shape
WINDOW_T, WINDOW_W = 8192, 4096
# the hf phase: each model exported through the transformers-free half of
# to_hf (models.hf_layout; the Mixtral layout is written here, as to_hf
# exports no MoE) and imported by its family's importer on the card: the
# slice phase's base() at full depth, and the published configurations
# cut to HF_LAYERS.  Logits on one (B, P) batch and greedy generate() at
# HF_GEN (B, P, N) from both models, prompts from seed HF_SEED; the
# imported mistral-w4096 and its source each take HF_STEPS eager steps
# at HF_TRAIN (B, T), SGD(0.01, momentum 0.9), all three kernels banded
HF_GEN, HF_SEED = (1, 1024, 16), 7
HF_LAYERS = {"mistral-w4096": 2, "mixtral-8x7b": 1}
HF_TRAIN, HF_STEPS = (1, 8192), 3
# the tensor phase: every function of singa_tpu_torch.tensor once on the
# card at base()'s widths, f32, against numpy: layout, creation and
# comparison functions exactly; elementwise math within TENSOR_RTOL of
# the largest magnitude (numpy in f64), reductions and products within
# TENSOR_SUM_RTOL (their summation order differs); the random draws by
# their mean and spread within TENSOR_STAT_TOL
TENSOR_SHAPE = (4096, 2048)
TENSOR_RTOL, TENSOR_SUM_RTOL, TENSOR_STAT_TOL = 1e-6, 1e-5, 0.01
# the cnn phase: ImageNet ResNet-50 at 224² and CIFAR ResNet-18 at 32²,
# each at B = CNN_B (bench.py's ResNet-50 cell), bf16 activations over
# f32 masters, SGD(lr 0.1, momentum 0.9, weight decay 1e-4), images and
# labels from seed CNN_SEED.  CNN_BITWISE steps eager (a second model
# from the same seed) and captured, under deterministic cuDNN, held
# bitwise; then, as the path normally runs, CNN_EAGER eager steps and
# CNN_STEPS timed replays of a fresh capture
CNN_B, CNN_SEED = 256, 0
CNN_BITWISE, CNN_EAGER, CNN_STEPS = 5, 3, 20
CNN_SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
# ResNet-50's forward at 224² in GFLOP, torchvision's 4.09 GMAC at 2
# FLOPs a multiply-add: the published count beside the counted one
RESNET50_GFLOP = 8.18
# the card's f32 step (TF32 off) against the port on the CPU at
# CNN_CHECK_B with the same weights: logits within CNN_F32_LOGIT of the
# largest logit, the loss within CNN_F32_LOSS relative, each gradient
# within CNN_F32_GRAD by Frobenius norm.  The gradients' limit is wide
# because the function is: at B = 8 an input changed by one ulp
# (x·(1 + 2⁻²³)) moves ResNet-50's f32 gradients on the card itself by
# ~2 % (median) to ~3 % (PERF.md): the script measures that spread and
# prints it beside the comparison.  The gate's other side is measured
# too: with a planted fault on the card (every convolution reading its
# weight flipped in H and W) the same comparison must exceed the limit
CNN_CHECK_B = 8
CNN_F32_LOGIT, CNN_F32_LOSS, CNN_F32_GRAD = 1e-4, 1e-5, 5e-2
# the CLI runs (singa_tpu_torch.tools.train_cnn): one epoch each of the
# synthetic sets (2,048 training, 256 test images)
CNN_CLI = (("cnn", "mnist"), ("vgg11", "cifar10"))
# the transformer phase: GPT-2 124M (GPT2Config(): vocab 50257, 1024
# positions, dim 768, 12 layers, 12 heads, dropout 0.1) and BERT-base
# (BERTConfig(num_labels=2)), published widths and depths, random
# weights from seed 0.  GPT-2: generate() (B, P, N) with bf16 weights;
# the paged engine (slots, max_len, block size, requests, new tokens)
# over prompts of GPT2_PROMPTS tokens from seed GPT2_SEED, bf16 weights;
# training at (B, T), fused loss, SGD(0.01, momentum 0.9), CONFIG_STEPS
# eager and captured steps held bitwise (losses and parameters), the
# step with the kernels against the plain versions at the train phase's
# limits over GPT2_GRAD_NAMES.  BERT at bench.py's cell (B, T), SGD(0.01,
# momentum 0.9), CONFIG_STEPS eager and captured steps held bitwise; an
# eval with a padding mask (BERT_EVAL_B rows, the last BERT_PAD
# positions padded); its f32 eval on the card against the port on the
# CPU (TF32 off) at BERT_CHECK_B rows: logits within BERT_F32_LOGIT of
# the largest
GPT2_GEN = (4, 512, 32)
GPT2_SERVE = (8, 1024, 32, 16, 64)
GPT2_PROMPTS, GPT2_SEED = (128, 640), 11
GPT2_TRAIN = (8, 1024)
GPT2_GRAD_NAMES = ("wte.table", "blocks.0.attn.q_proj.W",
                   "blocks.11.mlp.c_proj.W", "ln_f.gamma")
# GPT-2 with remat=True beside the plain model at GPT2_TRAIN: one eager
# step's loss and every gradient, then REMAT_STEPS steps through
# train_step (two eager, the rest captured) held bitwise, then
# REMAT_TIMED replays of each, alternating
REMAT_STEPS, REMAT_TIMED = 4, 10
BERT_TRAIN = (256, 128)
BERT_EVAL_B, BERT_PAD = 64, 40
BERT_CHECK_B, BERT_F32_LOGIT = 4, 1e-4
# the sonnx phase: BERT-base at bench.py's cell (BERT_TRAIN, SGD 0.01 /
# momentum 0.9, softmax_cross_entropy) exported by the port, its bytes
# parsed back and imported on the card, trained as the transformer phase
# trains the native model; GPT-2 124M exported and imported at the
# reference's session shape SONNX_GPT2 (B, T) for inference.  Logits of
# an import against its native model, both on the card: in f32 (TF32
# off) within SONNX_F32_LOGIT of the largest, which a planted fault (the
# parsed proto's SONNX_PLANT initializer scaled by SONNX_PLANT_SCALE)
# must exceed; in bf16 within LOGIT_RTOL, the bf16 gate.  Each at the
# export's own batch: an exported graph's shapes are static
SONNX_GPT2 = (8, 128)
SONNX_F32_LOGIT = 1e-4
SONNX_PLANT, SONNX_PLANT_SCALE = "blocks.11.ln_2.gamma", 1.01
SONNX_EVAL_CALLS = 10
# phase dist: DistOpt over NCCL at a world of 1 (the card's machine has
# one card); base()'s training cell through each sync mode, then
# ResNet-50 at phase cnn's cell
DIST_MODES = {"plain": {}, "int8_ring": {"compression": "int8_ring"},
              "zero1": {"shard_weight_update": True}}
DIST_EQUAL_STEPS = 2           # DistOpt vs the base optimizer, bitwise
# base()'s depth here (16 in phase train): the script's wall budget
DIST_LAYERS = 4
DIST_RESIDUAL_PARAM = "blocks.0.attn.q_proj.W"
DIST_RING_BLOCK = 256

# phase train_run: GPT-2 124M's widths (GPT2Config() cut to RUN_LAYERS
# layers, fused loss, dropout 0.1, f32 masters from seed 0) with
# AdamW(RUN_LR, weight decay RUN_WD) at GPT2_TRAIN through
# singa_tpu_torch.train.TrainRunner, over a DataLoader of RUN_SEQS
# synthetic sequences (seed RUN_DATA_SEED, shuffle seed 1,
# drop_last), checkpointed by AsyncCheckpointManager(**RUN_CKPT) in a
# temporary directory, RUN_STEPS steps.  The children are fresh
# interpreters that import RUN_BUILDER by name.  P: SIGTERM once a child
# reports RUN_PREEMPT_AFTER steps done; T+K: the RUN_TORN_AT-th commit
# torn after its marker, then the child killed between the last file's
# rename and its marker; R: a train.step error at step index
# RUN_RETRY_STEP (retried), then RUN_MAX_RETRIES + 1 at RUN_FAULT_STEP
# (aborted); H: a hang of RUN_HANG[1] s at step index RUN_HANG_STEP under
# a step_timeout of RUN_HANG[0] s.  The measuring tools' windowed median
# within RUN_WINDOW_TOL of the median of RUN_BESIDE replays timed right
# beside it as U's calls are (U's own replays run beside the runner's
# host work and its checkpoint writer, so they are reported, not held)
RUN_STEPS = 24
# GPT-2 124M's depth here (12 in phase transformer): the script's wall
# budget, spent mostly on the children's starts and 1.49 GB checkpoints
RUN_LAYERS = 4
RUN_SEQS = 512
RUN_DATA_SEED = 5
RUN_LR, RUN_WD = 3e-4, 0.1
RUN_CKPT = dict(save_every=8, keep_last=2, keep_every=16)
RUN_BUILDER = "chip_smoke:train_run_model"
RUN_PREEMPT_AFTER = 10
RUN_TORN_AT = 2
RUN_RETRY_STEP, RUN_FAULT_STEP, RUN_MAX_RETRIES = 5, 13, 2
RUN_HANG, RUN_HANG_STEP = (2.0, 8.0), 5
RUN_CHILD_TIMEOUT_S = 300
RUN_WINDOW_TOL = 0.05
RUN_BESIDE = 12
# torch.profiler loses the first device records of a session, more of
# them the longer the process has run (on an NVIDIA H100 80GB HBM3 at
# 700 W: none at first, ~20 after 5.5 minutes and 80 sessions, the
# same count whatever the idle before the call); so a profiled call follows
# PROFILE_WARMUP spin kernels, which take that loss; how many of their
# records a profile kept is in its line.
# profile_drops: how long it profiles one replayed GPT-2 step, with and
# without the warm-up, and the unprofiled replays between two rounds
PROFILE_WARMUP = 512
PROFILE_PROBE_S, PROFILE_GAP_S = 330.0, 8.0


#: what later phases put beside their own numbers, by phase
SUMMARY = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, iters=50, warmup=5):
    """Mean time of fn() over `iters` back-to-back calls, by CUDA events:
    the device's time when the host enqueues faster than the card runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, reps=20, replays=10):
    """Device time of one fn() call: `reps` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events, so the host's
    time per call is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def host_time_us(fn, iters=200):
    """Host time of one fn() call (enqueue only), microseconds."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def card_clocks():
    """The card's SM clock against its maximum, temperature, power draw
    and the reasons nvidia-smi gives for holding the clock down (a bit
    mask; 0 = none): a time taken while they are set is slower than the
    card's best."""
    fields = ["clocks.sm", "clocks.max.sm", "temperature.gpu",
              "power.draw", "clocks_event_reasons.active"]
    for _ in range(2):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(fields),
             "--format=csv,noheader"], capture_output=True, text=True)
        if smi.returncode == 0:
            vals = smi.stdout.strip().splitlines()[0].split(", ")
            return dict(zip(fields, vals))
        # drivers before 535 name the reasons clocks_throttle_reasons
        fields[-1] = "clocks_throttle_reasons.active"
    return {"nvidia_smi_error": smi.stderr.strip() or smi.stdout.strip()}


def smi_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_card():
    line = smi_line()
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": line, "torch_name": name,
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "clocks": card_clocks()})
    return name


def phase_build(tmp):
    """Build the kernels and, from copies of their sources in `tmp`, each
    planted fault: one nvcc per source, all started together."""
    from singa_tpu_torch import _build, kernel_check
    kernels = ("flash_fwd", "flash_bwd")
    faults = [(n, kernel_check.flash_fault_source(n))
              for n in kernel_check.FLASH_FAULTS]
    faults += [(n, kernel_check.flash_bwd_fault_source(n))
               for n in kernel_check.FLASH_BWD_FAULTS]
    srcs = [_build.source_path(k) for k in kernels]
    for name, text in faults:
        srcs.append(tmp / f"{name}.cu")
        srcs[-1].write_text(text)
    t0 = time.perf_counter()
    built = _build.build(srcs)
    for kernel, b in zip(kernels, built):
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln or "C75" in ln
                 or "Compiling entry function" in ln]
        # C7510-C7520 notes that ptxas serialised wgmma instructions
        serialised = [ln for ln in ptxas if "serialized" in ln]
        emit({"phase": "build", "kernel": kernel,
              "source": f"singa_tpu_torch/csrc/{kernel}.cu",
              "ptxas": ptxas, "wgmma_serialised": serialised})
    emit({"phase": "build", "nvcc_seconds": {b.path.name: round(b.seconds, 2)
                                             for b in built},
          "wall_seconds": round(time.perf_counter() - t0, 2)})
    return {name: b.lib for (name, _), b in zip(faults, built[2:])}


# the case that also carries a nonzero lse cotangent (folded into delta)
DLSE_CASE = "gqa_causal_d128"


def phase_kernels():
    from singa_tpu_torch import kernel_check
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for label in kernel_check.FLASH_CASES:
            errs = kernel_check.check_flash(label, dtype)
            results.append({"kernel": "flash_fwd", "case": label,
                            "dtype": str(dtype)[6:], **errs})
    for dtype in (torch.float32, torch.bfloat16):
        for label in kernel_check.FLASH_CASES:
            errs = kernel_check.check_flash_bwd(label, dtype)
            results.append({"kernel": "flash_bwd", "case": label,
                            "dtype": str(dtype)[6:], **errs})
        errs = kernel_check.check_flash_bwd(DLSE_CASE, dtype, dlse=True)
        results.append({"kernel": "flash_bwd", "case": DLSE_CASE + "+dlse",
                        "dtype": str(dtype)[6:], **errs})
    for r in results:
        emit({"phase": "kernels", **r})
    bad = [f"{r['kernel']}:{r['case']}/{r['dtype']}" for r in results
           if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    same = kernel_check.bwd_repeats_bitwise("train")
    emit({"phase": "kernels", "kernel": "flash_bwd", "case": "train",
          "dtype": "bfloat16", "two_launches_bitwise_equal": same})
    check(all(same.values()), f"two launches of the backward kernels "
          f"differ: {same}")


def phase_faults(libs):
    """Each planted fault, built from a copy of a kernel's source, must
    fail the limits that the kernel passes."""
    from singa_tpu_torch import kernel_check
    results = []
    for name, lib in libs.items():
        also = kernel_check.FAULT_ALSO_CASES.get(name, ())
        if name in kernel_check.FLASH_FAULTS:
            labels = (kernel_check.FLASH_FAULTS[name][0],) + also
            swap, run = kernel_check.flash_kernel, kernel_check.check_flash
        else:
            labels = (kernel_check.FLASH_BWD_FAULTS[name][0],) + also
            swap = kernel_check.flash_bwd_kernel
            run = kernel_check.check_flash_bwd
        for label in labels:
            with swap(lib):
                errs = run(label, torch.bfloat16)
            results.append({"fault": name, "case": label,
                            "dtype": "bfloat16", **errs,
                            "caught": not errs["ok"]})
    emit({"phase": "faults", "faults": results})
    missed = [f"{r['fault']}:{r['case']}" for r in results
              if not r["caught"]]
    check(not missed, f"planted faults pass the kernels' limits: {missed}")


class plain_attention:
    """Route the flash wrappers, forward and backward, to their plain
    versions for a comparison run (the main paths never do this)."""

    def __enter__(self):
        from singa_tpu_torch.ops import flash_attention as fa
        self.fa = fa
        self.saved = fa._flash_fwd_cuda, fa._flash_bwd_cuda
        fa._flash_fwd_cuda = fa._flash_fwd_reference
        fa._flash_bwd_cuda = fa._flash_bwd_reference

    def __exit__(self, *exc):
        self.fa._flash_fwd_cuda, self.fa._flash_bwd_cuda = self.saved


def _timed(fn):
    """(fn's result, seconds) with the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _median_ms(fn, n=5):
    return sorted(_timed(fn)[1] for _ in range(n))[n // 2] * 1e3


def tier_model(device, seed=0):
    """Llama(LlamaConfig.base()) on `device`, weights from `seed`: the
    slice phase's model, and what each worker process of the net phase
    builds (it imports this builder as chip_smoke:tier_model)."""
    from singa_tpu_torch.models import Llama, LlamaConfig
    gen = torch.Generator(device.torch_device.type).manual_seed(seed)
    return Llama(LlamaConfig.base(), device=device, generator=gen)


def phase_slice():
    from singa_tpu_torch import device
    from singa_tpu_torch.models import _generate
    from singa_tpu_torch.ops import flash_attention as fa

    dev = device.create_device("cuda")
    m, build_s = _timed(lambda: tier_model(dev))
    cfg = m.cfg
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, P))
    kw = dict(max_new_tokens=N, param_dtype=torch.bfloat16)
    S = P + N

    # eager: the same steps, each op launched from the host
    m.generate(prompts, use_graph=False, **kw)     # warm call
    out_eager, eager_s = _timed(lambda: m.generate(prompts, use_graph=False,
                                                   **kw))
    # captured: the first call is the warm-up, the second captures
    fa.reset_device_launches()
    m.generate(prompts, **kw)
    warm_launches = fa.device_launches()
    _, capture_call_s = _timed(lambda: m.generate(prompts, **kw))
    torch.cuda.reset_peak_memory_stats()
    fa.reset_device_launches()                     # the main path's run
    out, gen_s = _timed(lambda: m.generate(prompts, **kw))
    launches = fa.device_launches()
    peak = torch.cuda.max_memory_allocated()
    graphs = m._gen_sessions[(B, P, S, torch.bfloat16,
                              (0.0, None, None, None))].graphs
    prefill_ms = _median_ms(graphs["prefill"].replay)

    # the eager prefill alone, and its logits with the kernel vs the
    # plain version
    ids = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    params = {n: p.detach().to(torch.bfloat16)
              for n, p in m.get_params().items()}
    with torch.no_grad(), _generate._bound(m, params):
        prefill = _generate.prefill_step(m, S)
        eager_prefill_ms = _median_ms(lambda: prefill(ids))
        lg_kernel, _ = prefill(ids)
        with plain_attention():
            lg_plain, _ = prefill(ids)
    del params
    with plain_attention():
        out_plain = m.generate(prompts, use_graph=False, **kw)
    lg_kernel, lg_plain = lg_kernel.float(), lg_plain.float()
    dlogit = (lg_kernel - lg_plain).abs().max().item()
    ref_max = lg_plain.abs().max().item()
    agree = float((out[:, P:] == out_plain[:, P:]).mean())

    # the card's memory as sessions of other prompt lengths are added:
    # each holds its caches and graph pools, all share one bf16 weight copy
    def memory(p):
        return {"prompt_len": p, "sessions": len(m._gen_sessions),
                "allocated_bytes": torch.cuda.memory_allocated(),
                "reserved_bytes": torch.cuda.memory_reserved(),
                "peak_bytes": torch.cuda.max_memory_allocated()}
    sessions = [memory(P)]
    for p in SESSION_PROMPTS:
        for _ in range(2):                         # warm-up, capture
            m.generate(prompts[:, :p], **kw)
        sessions.append(memory(p))
    weight_copies = len(m._gen_params)
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       m._gen_params[torch.bfloat16][1].values())
    shared = len({id(s.params) for s in m._gen_sessions.values()}) == 1

    # generate = prefill + N - 1 decode steps
    decode_ms = (gen_s * 1e3 - prefill_ms) / (N - 1)
    eager_decode_ms = (eager_s * 1e3 - eager_prefill_ms) / (N - 1)
    result = {
        "phase": "slice", "config": "LlamaConfig.base()",
        "params": m.num_params(), "B": B, "P": P, "N": N,
        "param_dtype": "bfloat16", "model_build_s": build_s,
        "captured": graphs["decode"].graph is not None,
        "warm_launches": warm_launches, "launches": launches,
        "expected_launches": {"flash_fwd": cfg.num_layers,
                              "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
        "generate_ms": gen_s * 1e3, "prefill_ms": prefill_ms,
        "decode_ms_per_token": decode_ms,
        "tokens_per_s": B * N / gen_s,
        "capture_call_ms": capture_call_s * 1e3,
        "graphs": {n: {"num_ops": g.num_ops, "flops": g.flops(),
                       "pool_bytes": g.pool_bytes,
                       "capture_s": g.capture_seconds,
                       "launches": g.launches}
                   for n, g in graphs.items()},
        "eager": {"generate_ms": eager_s * 1e3,
                  "prefill_ms": eager_prefill_ms,
                  "decode_ms_per_token": eager_decode_ms,
                  "tokens_per_s": B * N / eager_s},
        "tokens_equal_eager": bool((out == out_eager).all()),
        "peak_memory_bytes": peak,
        "memory_by_session": sessions,
        "bf16_weight_copies": weight_copies,
        "bf16_weight_bytes": weight_bytes,
        "sessions_share_weights": shared,
        "prefill_logits_max_abs_diff": dlogit,
        "prefill_logits_max_abs": ref_max,
        "logit_rtol": LOGIT_RTOL,
        "greedy_token_agreement_vs_plain": agree,
    }
    emit(result)
    check(result["captured"], "generate() did not run captured graphs")
    check(warm_launches == launches == result["expected_launches"],
          f"the kernels ran {warm_launches} (warm-up) and {launches} "
          f"(captured) times in a generate call, expected "
          f"{result['expected_launches']}")
    check(weight_copies == 1 and shared, f"the sessions hold "
          f"{weight_copies} bf16 weight copies (shared: {shared})")
    check(graphs["prefill"].launches == {"flash_fwd": cfg.num_layers},
          f"the prefill graph holds {graphs['prefill'].launches}")
    check(out.shape == (B, P + N) and out.dtype == np.int32,
          f"generate returned {out.shape} {out.dtype}")
    check((out[:, :P] == prompts).all(), "prompt not echoed")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), "token out of range")
    check(result["tokens_equal_eager"],
          "captured greedy tokens differ from the eager call's")
    check(np.isfinite(lg_kernel.cpu().numpy()).all(), "non-finite logits")
    check(dlogit <= LOGIT_RTOL * ref_max,
          f"prefill logits differ by {dlogit} (max |logit| {ref_max})")
    phase_profile(lambda: m.generate(prompts, **kw),
                  f"one captured generate call, B={B} P={P} N={N}",
                  {"flash_fwd": cfg.num_layers})
    return launches["flash_fwd"], m


def serve_prompts(vocab):
    """The serve phase's 16 prompts, from a numpy seed: 8 share a
    256-token system prompt with private suffixes of 64-512 tokens, 8
    are private prompts of 128-768 tokens; interleaved."""
    rng = np.random.RandomState(5)
    system = rng.randint(0, vocab, SERVE_SYSTEM)
    half = SERVE_REQUESTS // 2
    shared = [np.concatenate([system, rng.randint(0, vocab, n)])
              for n in rng.randint(64, 513, half)]
    private = [rng.randint(0, vocab, n) for n in rng.randint(128, 769, half)]
    return [p.astype(np.int32) for pair in zip(shared, private)
            for p in pair]


def serve_engine(m, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                 block_size=SERVE_BLOCK, **kw):
    """A ServeEngine over `m` at the phase's shape (or the one given),
    warmed up: one request of two chunks and three tokens runs each
    program's first (eager) dispatch and its capture, then the metrics
    start afresh.  (engine, requests the warm-up admitted)."""
    from singa_tpu_torch.serve import ServeEngine
    from singa_tpu_torch.serve.metrics import ServeMetrics
    kw = {"param_dtype": torch.bfloat16, **kw}
    eng = ServeEngine(m, slots, max_len, block_size=block_size,
                      backoff_base=0.001, backoff_max=0.01, **kw)
    warm = np.random.RandomState(99).randint(0, m.cfg.vocab_size,
                                             block_size + 8)
    # long enough for two verify rounds on a spec engine
    eng.submit(warm, max_new_tokens=3 + 2 * eng.spec_k)
    eng.run_until_idle()
    warm_requests = eng.metrics.admitted
    eng.metrics = ServeMetrics(flight=eng.flight)
    return eng, warm_requests


def traffic(eng, prompts, recover_after=None, new_tokens=SERVE_NEW):
    """Submit every prompt at once and run to idle (with `recover_after`,
    step that many times, force a recovery, then run to idle):
    (streams, seconds, each request's TTFT in ms)."""
    hs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]

    def run():
        if recover_after is not None:
            for _ in range(recover_after):
                eng.step()
            eng.recover("chip_smoke: mid-wave")
        eng.run_until_idle()
    _, secs = _timed(run)
    return ([list(map(int, h.tokens)) for h in hs], secs,
            [h.ttft_s * 1e3 for h in hs])


def serve_traffic(eng, prompts):
    """Submit every prompt at once and run to idle: (streams, seconds)."""
    return traffic(eng, prompts)[:2]


def recovery_plan():
    """Three decode faults in a row (past the two retries) at the 20th
    tick, forcing a recovery, and one transient prefill fault."""
    from singa_tpu_torch import faults
    return faults.FaultPlan(
        [faults.FaultSpec("serve.decode", "error", at=20 + i)
         for i in range(3)]
        + [faults.FaultSpec("serve.prefill", "error", at=5)])


def _differ(got, expect):
    """Whether the streams equal `expect`, how many differ and the first
    position at which one does."""
    differ = [next(i for i, (a, b) in enumerate(zip(g, e)) if a != b)
              for g, e in zip(got, expect) if g != e]
    return {"streams_equal": got == expect,
            "requests_differing": len(differ),
            "first_differing_token": min(differ) if differ else None}


def wave_run(eng, wave, expect, plan=None, recover_after=None,
             keep_streams=False):
    """`wave` through `eng` (under a fault plan, or with a recovery
    after `recover_after` steps, if given): whether its streams equal
    `expect`, how many differ and the first position at which one does,
    its seconds and TTFT p50, the programs made and what the engine's
    counters moved by (and, with `keep_streams`, the streams beside)."""
    from singa_tpu_torch import faults
    before = eng.metrics.snapshot()
    with faults.active(plan) if plan is not None else nullcontext(), \
            warnings.catch_warnings():
        # a spec engine's fallback tick warns; the counters tell it
        warnings.simplefilter("ignore")
        got, secs, ttft = traffic(eng, wave, recover_after)
    after = eng.metrics.snapshot()
    out = {**_differ(got, expect), "seconds": secs,
           "ttft_p50_ms": float(np.median(ttft)),
           "compiled_counts": (eng.spec_compiled_counts()
                               if eng.spec_k else eng.compiled_counts())}
    for key in ("admitted", "recoveries", "preempted", "steps",
                "spec_rounds", "spec_fallbacks"):
        out[key] = after[key] - before[key]
    for site in ("serve.prefill", "serve.decode"):
        out[site.split(".")[1] + "_retries"] = (
            after["retries"].get(site, 0) - before["retries"].get(site, 0))
    if plan is not None:
        out["fired"] = plan.fire_count()
    return (out, got) if keep_streams else out


def _gap_summary(gaps, agree, limit):
    return {"max_gap": float(gaps.max()),
            "gap_p99": float(np.quantile(gaps, 0.99)),
            "positions": int(gaps.size),
            "positions_over_limit": int((gaps > limit).sum()),
            "argmax_agreement": agree}


def teacher_forced_gaps(m, eng, prompts, streams, plain=True):
    """Each request's prompt and engine tokens through one plain causal
    forward under the engine's weights: at every generated position the
    forward's largest logit minus its logit of the engine's token (0
    where they agree).  (all gaps, share of positions where the
    engine's token is the forward's argmax).  With `plain` False the
    forward runs the flash kernels (held against their plain versions in
    the kernels phase), its ids padded at the end to a multiple of 128
    so that they tile: a long window's plain band mask would not fit."""
    from singa_tpu_torch.models import _generate
    gaps = []
    with torch.no_grad(), _generate._bound(m, eng._params), \
            plain_attention() if plain else nullcontext():
        for p, toks in zip(prompts, streams):
            seq = np.concatenate([p, toks[:-1]])
            pad = 0 if plain else -seq.size % 128
            ids = torch.as_tensor(np.pad(seq, (0, pad))[None],
                                  dtype=torch.int64, device=eng._device)
            lg = m(ids)[0, p.size - 1:seq.size].float()
            tok = torch.as_tensor(toks, device=eng._device)
            gaps.append(lg.max(-1).values
                        - lg.gather(1, tok[:, None])[:, 0])
    gaps = torch.cat(gaps)
    return gaps.cpu().numpy(), float((gaps == 0).float().mean())


def faulty_gaps(m, fault, prompts, **kw):
    """A fresh engine over `m` captured with a planted fault in place,
    its streams for `prompts` and their teacher-forced gaps."""
    with fault:
        eng, _ = serve_engine(m, **kw)
        streams, _ = serve_traffic(eng, prompts)
    out = teacher_forced_gaps(m, eng, prompts, streams)
    eng.close()
    return out


def f32_model(cfg):
    """`cfg` at seed 0 on the card, computing in f32 (the card's default
    is bf16 activations)."""
    from singa_tpu_torch import device
    from singa_tpu_torch.models import Llama
    dev = device.create_device("cuda")
    dev.default_dtype = torch.float32
    return Llama(cfg, device=dev,
                 generator=torch.Generator("cuda").manual_seed(0))


def oracle_f32(cfg, prompts):
    """The teacher-forced oracle on an engine computing in f32 (f32
    weights, arena and activations) over `prompts`, sound and with the
    planted scatter fault: {"sound": (gaps, agreement), "fault": ...}."""
    m = f32_model(dataclasses.replace(cfg, num_layers=SERVE_ORACLE_LAYERS))
    eng, _ = serve_engine(m, param_dtype=None)
    streams, _ = serve_traffic(eng, prompts)
    out = {"sound": teacher_forced_gaps(m, eng, prompts, streams)}
    eng.close()
    out["fault"] = faulty_gaps(m, late_token_scatter(), prompts,
                               param_dtype=None)
    return out


class _swap:
    """Swap `module.name` for `make(saved)` while the context is open
    (for a fresh engine's capture)."""

    def __init__(self, module, name, make):
        self.module, self.name, self.make = module, name, make

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.make(self.saved))

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def late_token_scatter():
    """Planted fault: each decode token's k/v written one offset late in
    its block."""
    from singa_tpu_torch.ops import kv_cache

    def make(scatter):
        return lambda ck, cv, block, offset, k, v: scatter(
            ck, cv, block, (offset + 1) % SERVE_BLOCK, k, v)
    return _swap(kv_cache, "scatter_token_kv", make)


def null_block_scatter():
    """Planted fault: every decode token's k/v written into the null
    block, as a slot with a stale table row would write them."""
    from singa_tpu_torch.ops import kv_cache

    def make(scatter):
        return lambda ck, cv, block, offset, k, v: scatter(
            ck, cv, torch.zeros_like(block), offset, k, v)
    return _swap(kv_cache, "scatter_token_kv", make)


def phase_serve(m):
    """The paged ServeEngine over `m` (LlamaConfig.base(), f32 masters)
    serving bf16 weights: traffic, checks and readings.  Returns the
    main engine's flash launches and the requests it admitted, from the
    card's counters zeroed before its warm-up and read after its
    traffic, burst, fault runs and the runs without prefix sharing, and
    what the later serving phases reuse: the prompts, the streams, the
    first wave's rerun and the engine's tick and arena."""
    from singa_tpu_torch.models import _generate
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.serve import QueueFull

    t0 = time.perf_counter()
    cfg = m.cfg
    zero = dict.fromkeys(fa.KERNELS, 0)
    prompts = serve_prompts(cfg.vocab_size)
    fa.reset_device_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng, warm_requests = serve_engine(m)
    counts_warm = eng.compiled_counts()
    streams, secs = serve_traffic(eng, prompts)
    snap = eng.metrics.snapshot()
    peak = torch.cuda.max_memory_allocated() - base
    counts_traffic = eng.compiled_counts()
    # a burst past max_queue between two steps is refused
    burst = np.random.RandomState(98).randint(0, cfg.vocab_size, 8)
    try:
        for _ in range(eng.sched.max_queue + 1):
            eng.submit(burst, max_new_tokens=1)
        queue_full = False
    except QueueFull:
        queue_full = True
    eng.run_until_idle()
    # the first wave again: plain, through a recovery and without
    # prefix sharing; each held to the first wave's streams
    wave, expect = prompts[:SERVE_SLOTS], streams[:SERVE_SLOTS]
    plain = wave_run(eng, wave, expect)
    recovery = wave_run(eng, wave, expect, recovery_plan())
    eng.share_prefix = False
    private = wave_run(eng, wave, expect)
    eng.share_prefix = True
    launches = fa.device_launches()
    requests = warm_requests + eng.metrics.admitted

    arena_bytes = sum(t.numel() * t.element_size()
                      for kv in eng.pool.caches for t in kv)
    graphs = {"prefill_chunk": eng._prefill.graph, "decode": eng._decode.graph}
    pool_bytes = {n: g.pool_bytes for n, g in graphs.items()}
    # replays of the two captured programs on the idle engine (the same
    # kernels as under traffic: the decode tick's work does not depend
    # on how many slots are live)
    tick_ms = _median_ms(eng._decode, n=21)
    tick_device_ms = cuda_time_ms(eng._decode, iters=20, warmup=2)
    chunk_ms = _median_ms(eng._prefill, n=21)
    chunk_device_ms = cuda_time_ms(eng._prefill, iters=20, warmup=2)
    phase_profile(lambda: (eng._decode(), eng._toks.cpu()),
                  f"one decode tick of the serve engine ({SERVE_SLOTS} "
                  f"slots, replay + token fetch)", zero)
    gaps, agree = teacher_forced_gaps(m, eng, prompts, streams)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the other engines: none may launch a flash kernel either
    fa.reset_device_launches()
    eng, _ = serve_engine(m, num_blocks=SERVE_PREEMPT_BLOCKS)
    preempt = wave_run(eng, wave, expect)
    eng.close()
    del eng
    gross, gross_agree = faulty_gaps(m, null_block_scatter(), wave)
    gc.collect()
    torch.cuda.empty_cache()
    f32 = oracle_f32(cfg, prompts[:SERVE_ORACLE])
    gc.collect()
    torch.cuda.empty_cache()
    other_launches = fa.device_launches()

    # sequential generate() calls over as many prompts as generate()
    # keeps sessions: each session's first (eager) call and its capture
    # first, then the prompts timed through the captured sessions, as
    # bench.py's warm diagnostic times them
    seq_prompts = prompts[:_generate.MAX_SESSIONS]
    kw = dict(max_new_tokens=SERVE_NEW, param_dtype=torch.bfloat16)
    first_s = 0.0
    for p in seq_prompts:
        first_s += _timed(lambda: m.generate(p[None], **kw))[1]
        m.generate(p[None], **kw)
    seq, seq_s = _timed(lambda: [m.generate(p[None], **kw)[0, p.size:]
                                 for p in seq_prompts])
    seq_tokens = len(seq_prompts) * SERVE_NEW
    seq_agree = float(np.mean([np.mean(np.asarray(s) == np.asarray(e))
                               for s, e in zip(seq, streams)]))

    n_tok = sum(len(t) for t in streams)
    ttft = snap["ttft_ms"]
    result = {
        "phase": "serve", "config": "LlamaConfig.base()",
        "param_dtype": "bfloat16", "num_slots": SERVE_SLOTS,
        "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK,
        "requests": len(prompts), "max_new_tokens": SERVE_NEW,
        "prompt_lens": [int(p.size) for p in prompts],
        "compiled_counts": {"after_warm_up": counts_warm,
                            "after_traffic": counts_traffic,
                            "after_recovery": recovery["compiled_counts"],
                            "preemption_engine":
                            preempt["compiled_counts"]},
        "seconds": secs, "tokens": n_tok, "tokens_per_s": n_tok / secs,
        "ttft_ms": {"p50": ttft["p50"], "p99": ttft["p99"],
                    "max": ttft["max"]},
        "token_ms": snap["token_ms"],
        "prefill_chunk_ms": chunk_ms, "prefill_chunk_device_ms":
        chunk_device_ms, "decode_tick_ms": tick_ms,
        "decode_tick_device_ms": tick_device_ms,
        "prefix_hits": snap["prefix_hits"],
        "prefix_hit_tokens": snap["prefix_hit_tokens"],
        "preempted": snap["preempted"], "steps": snap["steps"],
        "arena_bytes": arena_bytes, "graph_pool_bytes": pool_bytes,
        "peak_memory_bytes": peak,
        "graphs": {n: {"num_ops": g.num_ops, "flops": g.flops(),
                       "capture_s": g.capture_seconds}
                   for n, g in graphs.items()},
        "queue_full_on_burst": queue_full,
        "main_engine": {"requests_admitted": requests,
                        "flash_launches": launches},
        "teacher_forced_bf16": {
            "limit": SERVE_BF16_GAP, "sound": _gap_summary(
                gaps, agree, SERVE_BF16_GAP),
            "planted_fault": _gap_summary(gross, gross_agree,
                                          SERVE_BF16_GAP),
            "fault": "null_block_scatter", "fault_requests": len(wave)},
        "teacher_forced_f32": {
            "delta": SERVE_DELTA, "requests": SERVE_ORACLE,
            "sound": _gap_summary(*f32["sound"], SERVE_DELTA),
            "planted_fault": _gap_summary(*f32["fault"], SERVE_DELTA),
            "fault": "late_token_scatter"},
        "wave": {"requests": len(wave), "plain": plain,
                 "recovery": recovery, "no_prefix_sharing": private,
                 "preemption": {"num_blocks": SERVE_PREEMPT_BLOCKS,
                                **preempt}},
        "other_engines_flash_launches": other_launches,
        "sequential_generate": {
            "prompts": len(seq_prompts),
            "captured_seconds": seq_s,
            "captured_tokens_per_s": seq_tokens / seq_s,
            "first_calls_eager_seconds": first_s,
            "token_agreement_with_engine": seq_agree},
        "tokens_per_s_over_sequential_captured":
        n_tok / secs / (seq_tokens / seq_s),
        "phase_seconds": time.perf_counter() - t0,
    }
    emit(result)
    check(counts_traffic == (1, 1) and recovery["compiled_counts"] == (1, 1)
          and preempt["compiled_counts"] == (1, 1),
          f"compiled_counts {result['compiled_counts']}, expected (1, 1)")
    check(all(len(t) == SERVE_NEW for t in streams)
          and all(0 <= x < cfg.vocab_size for t in streams for x in t),
          "the engine's streams are short or out of range")
    check(queue_full, "a burst past max_queue was not refused")
    check(snap["prefix_hits"] >= SERVE_REQUESTS // 2 - 1,
          f"only {snap['prefix_hits']} prefix hits")
    check(plain["streams_equal"], "the first wave alone gives other streams "
          "than in the full traffic")
    check(float(gaps.max()) <= SERVE_BF16_GAP, f"bf16 engine tokens fail "
          f"the teacher-forced check: max gap {gaps.max()}")
    check(float(gross.max()) > SERVE_BF16_GAP, f"the planted null-block "
          f"fault passes the bf16 teacher-forced check: max gap "
          f"{gross.max()}")
    check(float(f32["sound"][0].max()) <= SERVE_DELTA, f"f32 engine tokens "
          f"fail the teacher-forced oracle: max gap "
          f"{f32['sound'][0].max()} > {SERVE_DELTA}")
    check(float(f32["fault"][0].max()) > SERVE_DELTA, f"the planted scatter "
          f"fault passes the oracle: max gap {f32['fault'][0].max()}")
    check(private["streams_equal"] and private["admitted"] == len(wave),
          f"run without prefix sharing: {private}")
    check(recovery["streams_equal"] and recovery["recoveries"] == 1
          and recovery["prefill_retries"] >= 1,
          f"recovery run: {recovery}")
    check(preempt["streams_equal"] and preempt["preempted"] >= 1,
          f"preemption run: {preempt}")
    check(launches == zero, f"the flash kernels ran {launches} times on "
          f"the serve path")
    check(other_launches == zero, f"the flash kernels ran {other_launches} "
          f"times in the other engines")
    return launches, requests, {
        "prompts": prompts, "streams": streams, "wave": expect,
        "plain_wave": plain, "decode_tick_ms": tick_ms,
        "decode_tick_device_ms": tick_device_ms,
        "arena_bytes": arena_bytes, "peak_memory_bytes": peak,
        "tokens_per_s": n_tok / secs,
        "ttft_ms": {"p50": ttft["p50"], "p99": ttft["p99"]}}


def vs_plain(streams, expect):
    """A speculative run's streams against the plain engine's
    (`expect`): bitwise, and the share of tokens that agree."""
    return {**_differ(streams, expect),
            "token_agreement_with_plain": float(np.mean(
                [np.mean(np.asarray(g) == np.asarray(e))
                 for g, e in zip(streams, expect)]))}


def _graph_bytes(*programs):
    return {p.name: p.graph.pool_bytes for p in programs
            if p.graph is not None}


def draft_model(cfg):
    """LlamaConfig.base() cut to SPEC_DRAFT_LAYERS layers, random weights
    from seed 1: a draft that disagrees with the target."""
    from singa_tpu_torch import device
    from singa_tpu_torch.models import Llama
    return Llama(dataclasses.replace(cfg, num_layers=SPEC_DRAFT_LAYERS),
                 device=device.create_device("cuda"),
                 generator=torch.Generator("cuda").manual_seed(1))


def phase_spec(m, ctx):
    """Speculative decoding (spec_k=SPEC_K) over the serve phase's first
    wave: self-speculation (a cold run, then a rerun over the warm
    prefix cache, timed as the serve phase's plain rerun is), a
    disagreeing draft, a verify fault past the retries (plain-decode
    fallback) and a recovery mid-wave, each held bitwise to the plain
    engine's streams: the bf16 verify window picks what the decode step
    picks (PERF.md, section 6), so no f32 engine stands in.  Returns the
    flash launches of the main spec engine (none expected) and the
    requests it admitted."""
    from singa_tpu_torch import faults
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg = m.cfg
    wave, expect = ctx["prompts"][:SERVE_SLOTS], ctx["wave"]
    fa.reset_device_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng, warm_requests = serve_engine(m, draft_model=m, spec_k=SPEC_K)
    counts_warm = eng.spec_compiled_counts()
    streams, secs, ttft = traffic(eng, wave)
    snap = eng.metrics.snapshot()
    peak = torch.cuda.max_memory_allocated() - base
    counts = eng.spec_compiled_counts()
    self_spec = vs_plain(streams, expect)
    rerun = wave_run(eng, wave, expect)
    plan = faults.FaultPlan([faults.FaultSpec("serve.verify", "error",
                                              at=6 + i) for i in range(3)])
    fault = wave_run(eng, wave, expect, plan)
    recovery = wave_run(eng, wave, expect, recover_after=6)
    launches = fa.device_launches()
    requests = warm_requests + eng.metrics.admitted
    round_ms = _median_ms(eng._verify, n=21)
    round_device_ms = cuda_time_ms(eng._verify, iters=20, warmup=2)
    graph_bytes = _graph_bytes(eng._prefill, eng._decode, eng._verify)
    phase_profile(lambda: (eng._verify(), eng._spec_out.cpu()),
                  f"one verify round of the spec engine (k={SPEC_K}, "
                  f"{SERVE_SLOTS} slots, replay + fetch)",
                  dict.fromkeys(fa.KERNELS, 0))
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # a disagreeing draft: every round still yields one target token
    dm = draft_model(cfg)
    eng, _ = serve_engine(m, draft_model=dm, spec_k=SPEC_K)
    d_streams, d_secs, _ = traffic(eng, wave)
    d_snap = eng.metrics.snapshot()
    disagree = vs_plain(d_streams, expect)
    d_counts = eng.spec_compiled_counts()
    eng.close()
    del eng, dm
    gc.collect()
    torch.cuda.empty_cache()

    n_tok = sum(len(t) for t in streams)
    plain = ctx["plain_wave"]
    result = {
        "phase": "spec", "config": "LlamaConfig.base()",
        "param_dtype": "bfloat16", "spec_k": SPEC_K,
        "num_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
        "requests": len(wave), "max_new_tokens": SERVE_NEW,
        "compiled_counts": {"after_warm_up": counts_warm,
                            "after_traffic": counts,
                            "after_fallback": fault["compiled_counts"],
                            "after_recovery": recovery["compiled_counts"]},
        "self_speculation": {
            "accept_rate": snap["accept_rate"],
            "tokens_per_dispatch": snap["tokens_per_dispatch"],
            "spec_rounds": snap["spec_rounds"],
            "cold": {"seconds": secs, "tokens_per_s": n_tok / secs,
                     "ttft_p50_ms": float(np.median(ttft))},
            "rerun": {**rerun, "tokens_per_s": n_tok / rerun["seconds"]},
            "token_ms": snap["token_ms"], **self_spec},
        "plain_engine_rerun": {"seconds": plain["seconds"],
                         "tokens_per_s": n_tok / plain["seconds"],
                         "ttft_p50_ms": plain["ttft_p50_ms"],
                         "decode_tick_ms": ctx["decode_tick_ms"],
                         "decode_tick_device_ms":
                         ctx["decode_tick_device_ms"]},
        "verify_round_ms": round_ms,
        "verify_round_device_ms": round_device_ms,
        "graph_pool_bytes": graph_bytes, "peak_memory_bytes": peak,
        "disagreeing_draft": {
            "draft": f"LlamaConfig.base() cut to {SPEC_DRAFT_LAYERS} "
                     f"layers, seed 1",
            "accept_rate": d_snap["accept_rate"],
            "tokens_per_dispatch": d_snap["tokens_per_dispatch"],
            "spec_rounds": d_snap["spec_rounds"],
            "slot_dispatches": d_snap["slot_dispatches"],
            "seconds": d_secs, "tokens_per_s": n_tok / d_secs,
            "compiled_counts": d_counts, **disagree},
        "verify_fault": fault, "recovery": recovery,
        "main_engine": {"requests_admitted": requests,
                        "flash_launches": launches},
        "phase_seconds": time.perf_counter() - t0,
    }
    emit(result)
    check(counts == (1, 0, 1, 0), f"spec_compiled_counts {counts} after "
          f"the traffic, expected (1, 0, 1, 0)")
    check(fault["compiled_counts"] == (1, 1, 1, 0)
          and recovery["compiled_counts"] == (1, 1, 1, 0)
          and d_counts == (1, 0, 1, 0),
          f"spec_compiled_counts {result['compiled_counts']}, "
          f"disagreeing draft {d_counts}")
    check(fault["spec_fallbacks"] >= 1 and fault["fired"] == 3,
          f"the verify fault did not fall back: {fault}")
    check(recovery["recoveries"] == 1, f"recovery run: {recovery}")
    for name, h in (("self-speculation", self_spec), ("its rerun", rerun),
                    ("the disagreeing draft", disagree),
                    ("the verify fault", fault), ("the recovery", recovery)):
        check(h["streams_equal"], f"{name}'s streams differ from the plain "
              f"engine's: {h}")
    check(snap["accept_rate"] is not None and snap["accept_rate"] > 0.5,
          f"self-speculation accept rate {snap['accept_rate']}")
    check(d_snap["accept_rate"] < 0.05
          and d_snap["spec_rounds"] == d_snap["slot_dispatches"]
          and d_snap["tokens_per_dispatch"] >= 1.0,
          f"disagreeing draft: {result['disagreeing_draft']}")
    check(launches == dict.fromkeys(fa.KERNELS, 0),
          f"the flash kernels ran {launches} times on the spec path")
    return launches, requests


def equal_bytes_run(m, prompts, kv_dtype, num_blocks):
    """All of `prompts` at once over INT8_SLOTS slots and `num_blocks`
    blocks, without prefix sharing: (engine summary, streams).  Peak
    concurrency is read between steps."""
    eng, _ = serve_engine(m, slots=INT8_SLOTS, num_blocks=num_blocks,
                          kv_dtype=kv_dtype, share_prefix=False)
    hs = [eng.submit(p, max_new_tokens=MEM_NEW) for p in prompts]
    peak = 0

    def run():
        nonlocal peak
        while eng.pending:
            eng.step()
            peak = max(peak, eng.pool.active_count)
    _, secs = _timed(run)
    snap = eng.metrics.snapshot()
    n_tok = sum(len(h.tokens) for h in hs)
    out = {"kv_dtype": kv_dtype or "bfloat16", "num_blocks": num_blocks,
           "block_bytes": eng.pool.block_bytes,
           "arena_bytes": num_blocks * eng.pool.block_bytes,
           "peak_concurrency": peak, "seconds": secs,
           "tokens_per_s": n_tok / secs,
           "ttft_ms": {k: snap["ttft_ms"][k] for k in ("p50", "p99")},
           "decode_tick_ms": _median_ms(eng._decode, n=21),
           "compiled_counts": eng.compiled_counts(),
           "graph_pool_bytes": _graph_bytes(eng._prefill, eng._decode)}
    streams = [list(map(int, h.tokens)) for h in hs]
    eng.close()
    return out, streams


def scales_dropped():
    """Planted fault: the verify window's int8 scatter stores the codes
    without their scales (the positions keep the scales they held), as
    a scatter that forgot half of QuantKV would."""
    from singa_tpu_torch.ops import kv_cache

    def make(scatter):
        def faulty(ck, cv, blocks, offsets, k, v):
            if not isinstance(ck, kv_cache.QuantKV):
                return scatter(ck, cv, blocks, offsets, k, v)
            for c, x in ((ck, k), (cv, v)):
                c.q[blocks.long(), offsets.long()] = kv_cache.quantize_kv(x)[0]
            return ck, cv
        return faulty
    return _swap(kv_cache, "scatter_tokens_kv", make)


def misplaced_restore(num_blocks):
    """Planted fault: every restored block written one block further on
    (wrapping), so the prefix cache keys a block that holds other
    content."""
    from singa_tpu_torch.serve import mem

    def make(write):
        return lambda restore, blocks, payloads: write(
            restore, [(b + 1) % num_blocks for b in blocks], payloads)
    return _swap(mem, "write_blocks", make)


def spill_waves(m, prompts, spill, fault=None):
    """The spill run on a SPILL_POOL-block pool: 4 requests behind the
    system prompt, then the 8 private prompts (which evict its blocks),
    then the other 4 system-prompt requests.  (summary, third wave's
    streams)."""
    from singa_tpu_torch.serve import mem
    shared, private = prompts[0::2], prompts[1::2]
    with fault if fault is not None else nullcontext():
        eng, _ = serve_engine(m, num_blocks=SPILL_POOL,
                              spill_blocks=SPILL_STORE if spill else None)
        if spill:
            # warm the restore program up (eager, then captured) on the
            # null block's own bytes, as the warm-up request does the
            # engine's programs: the third wave times warm re-hits
            pool = eng.pool
            pool.restore = mem.Restore(pool.caches, pool.draft_caches)
            null = mem.read_block(pool.caches, pool.draft_caches, 0)
            for _ in range(2):
                mem.write_block(pool.restore, 0, null)
        traffic(eng, shared[:4], new_tokens=MEM_NEW)
        traffic(eng, private, new_tokens=MEM_NEW)
        spilled = eng.metrics.spilled_blocks
        third, secs, ttft = traffic(eng, shared[4:], new_tokens=MEM_NEW)
    snap = eng.metrics.snapshot()
    out = {"spill_blocks": SPILL_STORE if spill else None,
           "spilled_blocks": spilled, "prefetch_hits": snap["prefetch_hits"],
           "prefetch_wait_ms": snap["prefetch_wait_ms"],
           "third_wave_seconds": secs,
           "third_wave_ttft_ms": {"p50": float(np.median(ttft)),
                                  "first": ttft[0]},
           "restore_compiled_count": (
               mem.restore_compiled_count(eng.pool.restore)
               if eng.pool.restore is not None else 0),
           "restore_graph_pool_bytes": (
               eng.pool.restore.program.graph.pool_bytes
               if eng.pool.restore is not None
               and eng.pool.restore.program.graph is not None else None),
           "compiled_counts": eng.compiled_counts()}
    eng.close()
    return out, third


def phase_mem(m, ctx):
    """The memory hierarchy: the int8 arena at the serve phase's arena
    bytes over INT8_SLOTS slots beside the bf16 arena at the same bytes;
    the referee (an int8 draft arena under a bf16 target, self-
    speculation) over the first wave, sound and with the scales dropped;
    quantize_kv on the card against the CPU; and the spill tier.
    Returns the flash launches of its engines (none expected)."""
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.ops import kv_cache
    from singa_tpu_torch.serve import mem

    t0 = time.perf_counter()
    prompts, wave, expect = ctx["prompts"], ctx["prompts"][:SERVE_SLOTS], \
        ctx["wave"]
    zero = dict.fromkeys(fa.KERNELS, 0)
    fa.reset_device_launches()
    bf16_blocks = ctx["arena_bytes"] // (2 * m.cfg.num_layers * SERVE_BLOCK
                                         * m.cfg.num_kv_heads
                                         * m.cfg.head_dim * 2)
    int8_block = 2 * m.cfg.num_layers * SERVE_BLOCK * (
        m.cfg.num_kv_heads * m.cfg.head_dim + 4)
    int8_blocks = ctx["arena_bytes"] // int8_block
    twice = (prompts + prompts)[:INT8_SLOTS]
    int8, int8_streams = equal_bytes_run(m, twice, "int8", int8_blocks)
    bf16, bf16_streams = equal_bytes_run(m, twice, None, bf16_blocks)
    int8["token_agreement_with_bf16"] = float(np.mean(
        [np.mean(np.asarray(a) == np.asarray(b))
         for a, b in zip(int8_streams, bf16_streams)]))
    gc.collect()
    torch.cuda.empty_cache()

    def referee(fault=None):
        with fault if fault is not None else nullcontext():
            eng, _ = serve_engine(m, draft_model=m, spec_k=SPEC_K,
                                  draft_kv_dtype="int8")
            streams, secs = serve_traffic(eng, wave)
        out = {"accept_rate": eng.metrics.snapshot()["accept_rate"],
               "tokens_per_dispatch":
               eng.metrics.snapshot()["tokens_per_dispatch"],
               "seconds": secs, "compiled_counts":
               eng.spec_compiled_counts(), **vs_plain(streams, expect)}
        eng.close()
        return out
    sound = referee()
    planted = referee(scales_dropped())
    gc.collect()
    torch.cuda.empty_cache()

    # quantize_kv on the card against the CPU, bitwise
    rng = np.random.RandomState(3)
    quant = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.randn(8, 32, 8, 128).astype(np.float32)
                             * rng.uniform(0.01, 50, (8, 32, 1, 1))
                             .astype(np.float32)).to(dt)
        cq, cs = kv_cache.quantize_kv(x)
        gq, gs = kv_cache.quantize_kv(x.cuda())
        quant[str(dt).split(".")[1]] = bool(
            torch.equal(gq.cpu(), cq) and torch.equal(gs.cpu(), cs))

    with_spill, third = spill_waves(m, prompts, True)
    without, third_plain = spill_waves(m, prompts, False)
    faulty, third_faulty = spill_waves(m, prompts, True,
                                       misplaced_restore(SPILL_POOL))
    launches = fa.device_launches()
    result = {
        "phase": "mem", "config": "LlamaConfig.base()",
        "param_dtype": "bfloat16",
        "equal_bytes": {"arena_bytes": ctx["arena_bytes"],
                        "num_slots": INT8_SLOTS, "requests": len(twice),
                        "share_prefix": False,
                        "int8": int8, "bf16": bf16},
        "referee": {"spec_k": SPEC_K, "draft_kv_dtype": "int8",
                    "min_accept_rate": REFEREE_MIN_ACCEPT,
                    "sound": sound, "scales_dropped": planted},
        "quantize_kv_card_equals_cpu": quant,
        "spill": {"num_blocks": SPILL_POOL, "with_spill": with_spill,
                  "without_spill": without,
                  "third_wave_equal_without_spill": third == third_plain,
                  "misplaced_restore": {
                      **faulty, "third_wave_equal_without_spill":
                      third_faulty == third_plain}},
        "flash_launches": launches,
        "restore_compiled_count_max": mem.restore_compiled_count(),
        "phase_seconds": time.perf_counter() - t0,
    }
    emit(result)
    check(int8["arena_bytes"] <= ctx["arena_bytes"]
          and bf16["arena_bytes"] <= ctx["arena_bytes"]
          and int8["compiled_counts"] == (1, 1)
          and bf16["compiled_counts"] == (1, 1),
          f"equal-byte arenas: {result['equal_bytes']}")
    check(all(len(t) == MEM_NEW for t in int8_streams),
          "the int8 engine's streams are short")
    check(int8["peak_concurrency"] > bf16["peak_concurrency"],
          f"the int8 arena holds no more requests than the bf16 one at "
          f"equal bytes: {int8['peak_concurrency']} vs "
          f"{bf16['peak_concurrency']}")
    check(sound["streams_equal"], f"the referee's target streams differ "
          f"from the plain engine's: {sound}")
    check(sound["accept_rate"] >= REFEREE_MIN_ACCEPT,
          f"the int8 draft arena's accept rate {sound['accept_rate']} is "
          f"under {REFEREE_MIN_ACCEPT}")
    check(planted["accept_rate"] < REFEREE_MIN_ACCEPT,
          f"the planted scale fault passes the referee: accept rate "
          f"{planted['accept_rate']}")
    check(all(quant.values()), f"quantize_kv on the card differs from the "
          f"CPU: {quant}")
    check(with_spill["spilled_blocks"] >= SERVE_SYSTEM // SERVE_BLOCK
          and with_spill["prefetch_hits"] >= SERVE_SYSTEM // SERVE_BLOCK,
          f"the spill tier did not spill and restore the system prompt: "
          f"{with_spill}")
    check(with_spill["restore_compiled_count"] <= 1
          and result["restore_compiled_count_max"] <= 1,
          f"the restore program was made more than once: {with_spill}")
    check(third == third_plain, "the third wave's streams differ with the "
          "spill tier")
    check(third_faulty != third_plain, "the misplaced restore leaves the "
          "third wave's streams unchanged")
    check(launches == zero, f"the flash kernels ran {launches} times on "
          f"the mem path")
    return launches


class handoff_log:
    """While open, wrap the handoff's extract and inject
    (singa_tpu_torch.serve.disagg.handoff, which the engine's methods
    call): per extract its host ms, the package's bytes and blocks and
    whether it carries the draft's KV; per inject its host ms, its
    destination engine and the blocks that engine mapped copy-free."""

    def __enter__(self):
        from singa_tpu_torch.serve.disagg import handoff
        self.mod, self.saved = handoff, (handoff.extract, handoff.inject)
        self.extracts, self.injects = [], []
        extract, inject = self.saved

        def logged_extract(engine, slot):
            t = time.perf_counter()
            pkg = extract(engine, slot)
            self.extracts.append({
                "host_ms": (time.perf_counter() - t) * 1e3,
                "bytes": sum(x.numel() * x.element_size()
                             for kv in pkg.kv + (pkg.draft_kv or [])
                             for x in kv),
                "blocks": pkg.n_blocks, "draft": pkg.draft_kv is not None})
            return pkg

        def logged_inject(engine, pkg):
            shared, _ = handoff._probe(engine, pkg)
            t = time.perf_counter()
            ok = inject(engine, pkg)
            if ok:
                self.injects.append({
                    "host_ms": (time.perf_counter() - t) * 1e3,
                    "engine": engine, "shared": shared})
            return ok
        handoff.extract, handoff.inject = logged_extract, logged_inject
        return self

    def __exit__(self, *exc):
        self.mod.extract, self.mod.inject = self.saved


def _summary(xs):
    xs = np.asarray(xs, dtype=np.float64)
    return {"n": int(xs.size), "min": float(xs.min()),
            "p50": float(np.median(xs)), "max": float(xs.max())}


def _fresh_metrics(workers):
    """Every worker's serve metrics started afresh (after a warm-up)."""
    from singa_tpu_torch.serve.metrics import ServeMetrics
    for w in workers:
        w.engine.metrics = ServeMetrics(flight=w.engine.flight)


def tier_wave(tier, wave, expect, plan=None, kill_after=None):
    """`wave` through a tier (under a fault plan, or with the first
    decode worker that holds requests killed after `kill_after` rounds):
    whether its streams equal `expect`, its seconds, and what the
    tier's counters moved by."""
    from singa_tpu_torch import faults
    m = tier.metrics
    before = (m.handoffs, m.reroutes, m.worker_deaths)
    with faults.active(plan) if plan is not None else nullcontext(), \
            warnings.catch_warnings():
        # a re-route or a death warns; the counters tell it
        warnings.simplefilter("ignore")
        hs = [tier.submit(p, max_new_tokens=SERVE_NEW) for p in wave]
        t0 = time.perf_counter()
        if kill_after is not None:
            for _ in range(kill_after):
                tier.step()
            victim = next(w for w in tier.decode
                          if w.alive and w.engine.running_items())
            tier.kill_worker(victim.name, "chip_smoke: mid-flight")
        tier.run_until_idle()
        secs = time.perf_counter() - t0
    got = [list(map(int, h.tokens)) for h in hs]
    out = {**_differ(got, expect), "seconds": secs}
    for key, b in zip(("handoffs", "reroutes", "worker_deaths"), before):
        out[key] = getattr(m, key) - b
    if plan is not None:
        out["fired"] = plan.fire_count()
    return out


def _worker_bytes(eng):
    """A worker's arena bytes and its captured programs' pool bytes."""
    progs = {p.name: p.graph.pool_bytes
             for p in (eng._prefill, eng._decode, eng._verify, eng._handoff)
             if p is not None and p.graph is not None
             and p.graph.graph is not None}
    return {"arena": sum(t.numel() * t.element_size()
                         for kv in eng.pool.caches + (eng.pool.draft_caches
                                                      or [])
                         for t in kv),
            "graph_pools": progs}


def phase_disagg(m, ctx):
    """The disaggregated tier in one process over `m`: DISAGG_POOLS
    workers of the serve phase's engine behind a Router, from one warmed
    template's weight copy.  The serve phase's traffic, held bitwise to
    its streams; the first wave through a handoff fault, a decode worker
    killed mid-flight and a self-speculative tier.  Returns the flash
    launches counted on the card over the phase."""
    from singa_tpu_torch import faults
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.serve import Router, build_pools

    t0 = time.perf_counter()
    zero = dict.fromkeys(fa.KERNELS, 0)
    prompts, streams = ctx["prompts"], ctx["streams"]
    wave = prompts[:SERVE_SLOTS]
    fa.reset_device_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kw = dict(num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
              block_size=SERVE_BLOCK, share_prefix=True,
              param_dtype=torch.bfloat16, backoff_base=0.001,
              backoff_max=0.01)
    template, _ = serve_engine(m)
    pw, dw = build_pools(m, *DISAGG_POOLS, template=template, **kw)
    tier = Router(pw, dw)
    workers = pw + dw
    # warm-up: two requests of two chunks at once, one handed to each
    # decode worker; a second pair captures the handoff program
    warm = np.random.RandomState(99).randint(0, m.cfg.vocab_size,
                                             SERVE_BLOCK + 8)
    for _ in range(2):
        for _ in range(len(dw)):
            tier.submit(warm, max_new_tokens=3)
        tier.run_until_idle()
    counts_warm = {w.name: w.engine.compiled_counts() for w in workers}
    _fresh_metrics(workers)
    tier.metrics = type(tier.metrics)(tier)
    with handoff_log() as log:
        hs = [tier.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
        _, secs = _timed(tier.run_until_idle)
    got = [list(map(int, h.tokens)) for h in hs]
    snap = tier.metrics.snapshot()
    peak = torch.cuda.max_memory_allocated() - base
    counts = {w.name: w.engine.compiled_counts() for w in workers}
    handoff_counts = {w.name: w.engine.handoff_compiled_count()
                      for w in workers}
    ptrs = {tuple(t.data_ptr() for t in e._params.values())
            for e in [template] + [w.engine for w in workers]}
    shared = {w.name: sum(i["shared"] for i in log.injects
                          if i["engine"] is w.engine) for w in dw}
    system = prompts[0][:SERVE_SYSTEM]         # prompt 0 shares it
    n_system = sum(np.array_equal(p[:SERVE_SYSTEM], system)
                   for p in prompts)
    # the handoff's parts: the gather program (a replay at the last
    # slot) and the package's copy of a median package's positions, by
    # events; the inject by the host's clock, as it ran
    src, src_name = pw[0].engine, pw[0].name
    n = int(np.median([e["blocks"] for e in log.extracts])) * SERVE_BLOCK
    gather_ms = cuda_time_ms(src._handoff, iters=20, warmup=2)
    copy_ms = cuda_time_ms(lambda: [(k[:, :n].clone(), v[:, :n].clone())
                                    for k, v in src._hout],
                           iters=20, warmup=2)
    pool_bytes = {w.name: _worker_bytes(w.engine) for w in workers}

    # the first wave again: through a handoff fault, and with a decode
    # worker killed mid-flight (re-prefilled on the prefill worker)
    fault = tier_wave(tier, wave, ctx["wave"], faults.FaultPlan(
        [faults.FaultSpec("serve.handoff", "error", at=DISAGG_FAULT_AT)]))
    kill = tier_wave(tier, wave, ctx["wave"], kill_after=TIER_KILL_AFTER)
    tier.close()
    template.close()
    del tier, template, pw, dw, workers
    gc.collect()
    torch.cuda.empty_cache()

    # a self-speculative tier: its packages carry the draft's KV
    spec_tmpl, _ = serve_engine(m, draft_model=m, spec_k=SPEC_K)
    spw, sdw = build_pools(m, 1, 1, template=spec_tmpl, draft_model=m,
                           spec_k=SPEC_K, **kw)
    stier = Router(spw, sdw)
    with handoff_log() as slog:
        spec = tier_wave(stier, wave, ctx["wave"])
    spec_snap = stier.metrics.snapshot()
    spec["accept_rate"] = spec_snap["accept_rate"]
    spec["tokens_per_dispatch"] = spec_snap["tokens_per_dispatch"]
    spec["packages_with_draft_kv"] = sum(e["draft"] for e in slog.extracts)
    spec["spec_compiled_counts"] = {
        w.name: w.engine.spec_compiled_counts() for w in spw + sdw}
    stier.close()
    spec_tmpl.close()
    launches = fa.device_launches()

    n_tok = sum(len(t) for t in got)
    result = {
        "phase": "disagg", "config": "LlamaConfig.base()",
        "param_dtype": "bfloat16", "pools": {"prefill": DISAGG_POOLS[0],
                                             "decode": DISAGG_POOLS[1]},
        "num_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
        "block_size": SERVE_BLOCK, "requests": len(prompts),
        "max_new_tokens": SERVE_NEW, **_differ(got, streams),
        "compiled_counts": {"after_warm_up": counts_warm,
                            "after_traffic": counts},
        "handoff_compiled_counts": handoff_counts,
        "one_weight_copy": len(ptrs) == 1,
        "handoffs": snap["handoffs"],
        "system_prompt_requests": n_system,
        "blocks_mapped_copy_free": shared,
        "seconds": secs, "tokens": n_tok, "tokens_per_s": n_tok / secs,
        "ttft_ms": {"p50": snap["ttft_ms"]["p50"],
                    "p99": snap["ttft_ms"]["p99"]},
        "serve_phase": {"tokens_per_s": ctx["tokens_per_s"],
                        "ttft_ms": ctx["ttft_ms"]},
        "handoff": {
            "gather_program_ms": gather_ms,
            "package_copy_ms": copy_ms, "package_copy_positions": n,
            "extract_host_ms": _summary([e["host_ms"]
                                         for e in log.extracts]),
            "inject_host_ms": _summary([i["host_ms"] for i in log.injects]),
            "wait_ms": snap["handoff_ms"],
            "package_bytes": _summary([e["bytes"] for e in log.extracts]),
            "package_blocks": _summary([e["blocks"]
                                        for e in log.extracts])},
        "pool_bytes": pool_bytes, "peak_memory_bytes": peak,
        "wave": {"requests": len(wave), "handoff_fault": fault,
                 "decode_worker_killed": kill, "self_speculation": spec},
        "flash_launches": launches,
        "phase_seconds": time.perf_counter() - t0,
    }
    emit(result)
    check(got == streams, f"the tier's streams differ from the serve "
          f"phase's: {_differ(got, streams)}")
    check(all(a <= 1 and b <= 1 for a, b in counts.values()),
          f"a worker made a program twice: {counts}")
    check(handoff_counts[src_name] == 1,
          f"handoff programs made: {handoff_counts}")
    check(len(ptrs) == 1, "the workers serve from more than one weight copy")
    check(snap["handoffs"] == len(prompts),
          f"{snap['handoffs']} handoffs for {len(prompts)} requests")
    check(sum(shared.values()) >= (n_system - len(shared))
          * (SERVE_SYSTEM // SERVE_BLOCK),
          f"system-prompt blocks mapped copy-free: {shared}")
    check(fault["streams_equal"] and fault["reroutes"] == 1
          and fault["fired"] == 1, f"handoff fault run: {fault}")
    check(kill["streams_equal"] and kill["worker_deaths"] == 1,
          f"decode worker kill run: {kill}")
    check(spec["streams_equal"]
          and spec["packages_with_draft_kv"] == len(wave),
          f"self-speculative tier: {spec}")
    check(launches == zero, f"the flash kernels ran {launches} times on "
          f"the disagg path")
    return launches


def _settle_heal(tier, deadline_s):
    """Step `tier` until its respawned workers are adopted and every
    pool is back at its target: the seconds it took."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        tier.step()
        hs = tier.heal_state()
        if (not any(hs["spawning"].values())
                and not any(hs["staged"].values())
                and all(hs["alive"][r] >= hs["target"][r]
                        for r in ("prefill", "decode"))):
            return time.monotonic() - t0
        time.sleep(0.05)
    raise AssertionError(f"the process tier did not heal: "
                         f"{tier.heal_state()}")


def phase_net(ctx):
    """The process tier: NET_POOLS worker processes on the card, each
    building base() from chip_smoke:tier_model, behind a ProcRouter.
    The serve phase's first wave, cold and warm, through a torn frame
    and with a decode worker killed mid-flight; each bitwise."""
    from singa_tpu_torch import faults
    from singa_tpu_torch.serve import ProcRouter, build_proc_pools
    from singa_tpu_torch.serve.net import supervisor

    t0 = time.perf_counter()
    wave, expect = ctx["prompts"][:SERVE_SLOTS], ctx["wave"]
    (pw, dw), spawn_s = _timed(lambda: build_proc_pools(
        "chip_smoke:tier_model", *NET_POOLS, num_slots=SERVE_SLOTS,
        max_len=SERVE_MAX_LEN, block_size=SERVE_BLOCK, share_prefix=True,
        param_dtype=torch.bfloat16, device="cuda",
        spawn_timeout_s=NET_SPAWN_TIMEOUT_S, backoff_base=0.001,
        backoff_max=0.01))
    tier = ProcRouter(pw, dw)
    try:
        ready = {w.name: w.ready_ms / 1e3 for w in tier.workers()}
        cold = tier_wave(tier, wave, expect)
        warm_ticks = {w.name: w.warm_tick_s for w in tier.workers()}
        warm = tier_wave(tier, wave, expect)
        stats = tier.transport_stats()
        wire = {"handoffs": tier.metrics.handoffs,
                "wire_bytes": tier.metrics.wire_bytes,
                "bytes_per_package": (tier.metrics.wire_bytes
                                      / max(1, tier.metrics.handoffs)),
                "ser_deser_ms": tier.metrics._ser.summary(),
                "wait_ms": tier.metrics.handoff_summary()}
        torn = tier_wave(tier, wave, expect, faults.FaultPlan.parse(
            "serve.transport=torn_frame:at=2"))
        torn["torn_frames"] = tier.metrics.torn_frames
        hs = [tier.submit(p, max_new_tokens=SERVE_NEW) for p in wave]
        for _ in range(TIER_KILL_AFTER):
            tier.step()
        victim = tier.decode[0]
        victim.proc.kill()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, replay_s = _timed(tier.run_until_idle)
            heal_s = _settle_heal(tier, NET_SPAWN_TIMEOUT_S)
        kill = {**_differ([list(map(int, h.tokens)) for h in hs], expect),
                "seconds": replay_s, "heal_seconds": heal_s,
                "worker_deaths": tier.metrics.worker_deaths,
                "respawns": tier.metrics.respawns,
                "decode_alive": tier.heal_state()["alive"]["decode"],
                "respawned_ready_s": {w.name: w.ready_ms / 1e3
                                      for w in tier.decode}}
    finally:
        tier.close()
    n_tok = len(wave) * SERVE_NEW
    result = {
        "phase": "net", "config": "LlamaConfig.base()",
        "param_dtype": "bfloat16", "builder": "chip_smoke:tier_model",
        "pools": {"prefill": NET_POOLS[0], "decode": NET_POOLS[1]},
        "requests": len(wave), "max_new_tokens": SERVE_NEW,
        "spawn_seconds": spawn_s, "ready_seconds": ready,
        "warm_up_tick_seconds": warm_ticks,
        "compile_timeout_s": supervisor._COMPILE_TIMEOUT_S,
        "cold": cold, "warm": warm,
        "tokens_per_s": n_tok / warm["seconds"],
        "in_process_tokens_per_s": n_tok / ctx["plain_wave"]["seconds"],
        "wire": wire, "transport": stats, "torn_frame": torn,
        "decode_worker_killed": kill,
        "processes_left": sum(p.poll() is None for p in tier.fabric.procs),
        "phase_seconds": time.perf_counter() - t0,
    }
    emit(result)
    check(cold["streams_equal"] and warm["streams_equal"],
          f"the process tier's streams differ: cold {cold}, warm {warm}")
    check(all(s < supervisor._COMPILE_TIMEOUT_S
              for s in warm_ticks.values()),
          f"a warm-up tick outran the compile budget: {warm_ticks}")
    check(torn["streams_equal"] and torn["torn_frames"] == 1
          and torn["reroutes"] >= 1, f"torn frame run: {torn}")
    check(kill["streams_equal"] and kill["worker_deaths"] == 1
          and kill["respawns"] == 1 and kill["decode_alive"] == NET_POOLS[1],
          f"killed worker run: {kill}")
    check(result["processes_left"] == 0, "a worker process outlived the "
          "tier")


@contextmanager
def _f32_activations(m):
    """`m` computing in f32 (its masters are f32; the card's default
    activation dtype is bf16) while the context is open."""
    dev = m.device
    saved = dev.default_dtype
    dev.default_dtype = torch.float32
    try:
        yield
    finally:
        dev.default_dtype = saved


def beam_tick_ms(sess, n=5):
    """Median over `n` searches of one replayed beam tick's ms: each
    search replays the prefill, then BEAM_N ticks timed together (a
    tick past the last would write past the session's tokens)."""
    times = []
    for _ in range(n):
        sess.graphs["prefill"].replay()
        times.append(_timed(lambda: [sess.graphs["tick"].replay()
                                     for _ in range(BEAM_N)])[1])
    return sorted(times)[n // 2] * 1e3 / BEAM_N


def phase_beam(m):
    """generate_beam on two of the slice phase's prompts (P=1024, N=32,
    num_beams=4, bf16 weights), without and with an eos id: captured
    against eager bitwise, num_beams=1 against greedy generate()
    bitwise, the returned scores against one teacher-forced f32
    forward, and the flash forward's launches per captured call.
    Returns those launches."""
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg = m.cfg
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                               (B, P))[:BEAM_B]
    kw = dict(max_new_tokens=BEAM_N, num_beams=BEAM_K,
              param_dtype=torch.bfloat16, return_scores=True)
    runs = {}
    launches = None
    eos = None
    for name in ("no_eos", "eos"):
        e = eos if name == "eos" else None
        eager, eager_scores = m.generate_beam(prompts, use_graph=False,
                                              eos_id=e, **kw)
        m.generate_beam(prompts, eos_id=e, **kw)          # warm-up
        _, capture_s = _timed(lambda: m.generate_beam(prompts, eos_id=e,
                                                      **kw))
        fa.reset_device_launches()
        (out, scores), call_s = _timed(
            lambda: m.generate_beam(prompts, eos_id=e, **kw))
        got = fa.device_launches()
        launches = got if launches is None else launches
        sess = m._gen_sessions[("beam", BEAM_B, BEAM_K, P, P + BEAM_N,
                                torch.bfloat16, e)]
        tick_ms = beam_tick_ms(sess)
        runs[name] = {"eos_id": e, "call_ms": call_s * 1e3,
                      "capture_call_ms": capture_s * 1e3,
                      "tick_ms": tick_ms,
                      "graph_pool_bytes": {n: g.pool_bytes for n, g in
                                           sess.graphs.items()},
                      "launches": got,
                      "captured_equals_eager": bool((out == eager).all()),
                      "scores_equal_eager": bool(
                          (scores == eager_scores).all()),
                      "out": out, "scores": scores}
        if eos is None:
            eos = int(out[0, P + 2])
    # num_beams=1 against greedy generate()
    one = m.generate_beam(prompts, max_new_tokens=BEAM_N, num_beams=1,
                          param_dtype=torch.bfloat16)
    greedy = m.generate(prompts, max_new_tokens=BEAM_N,
                        param_dtype=torch.bfloat16)
    # the returned scores against one teacher-forced f32 forward
    out, scores = runs["no_eos"]["out"], runs["no_eos"]["scores"]
    dev = m.device.torch_device
    with torch.no_grad(), _f32_activations(m), plain_attention():
        ids = torch.as_tensor(out[:, :-1], dtype=torch.int64, device=dev)
        lp = torch.log_softmax(m(ids).float(), dim=-1)
        tgt = torch.as_tensor(out[:, 1:], dtype=torch.int64, device=dev)
        forced = lp.gather(2, tgt[:, :, None])[:, P - 1:, 0].sum(1).cpu()
    forced = forced.numpy()
    rel = np.abs(forced - scores) / np.abs(forced)
    for r in runs.values():
        r.pop("out")
        r["scores"] = [float(x) for x in r.pop("scores")]
    result = {"phase": "beam", "config": "LlamaConfig.base()",
              "param_dtype": "bfloat16", "B": BEAM_B, "num_beams": BEAM_K,
              "P": P, "N": BEAM_N, "runs": runs,
              "one_beam_equals_greedy": bool((one == greedy).all()),
              "scores_vs_teacher_forced_f32": {
                  "forced": [float(x) for x in forced],
                  "max_rel_diff": float(rel.max()),
                  "rtol": BEAM_SCORE_RTOL},
              "phase_seconds": time.perf_counter() - t0}
    emit(result)
    for name, r in runs.items():
        check(r["captured_equals_eager"] and r["scores_equal_eager"],
              f"captured beam search differs from eager ({name})")
        check(r["launches"] == {"flash_fwd": cfg.num_layers,
                                "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
              f"a captured beam call launched {r['launches']} ({name})")
    check(result["one_beam_equals_greedy"],
          "num_beams=1 differs from greedy generate()")
    check(float(rel.max()) <= BEAM_SCORE_RTOL, f"beam scores differ from "
          f"the teacher-forced f32 forward's: {rel.max()}")
    return launches["flash_fwd"]


def _llama_loss(m, x):
    """base()'s training loss: the fused loss against the lm head."""
    from singa_tpu_torch.models.transformer import next_token_loss_fused
    return next_token_loss_fused(m.features(x), m.lm_head, x,
                                 chunk_rows=m.cfg.fused_loss_chunk)


def _loss_and_grads(m, ids, names=GRAD_NAMES, loss_fn=_llama_loss):
    """One step's loss and the gradients of `names`, without an update
    (the path of train_one_batch up to the optimizer)."""
    from singa_tpu_torch import autograd
    x = torch.as_tensor(ids, device="cuda")
    params = m.get_params()
    ids_of = {id(p): n for n, p in params.items()}
    with autograd.train_mode():
        loss = loss_fn(m, x)
        grads = {ids_of[id(p)]: g for p, g in autograd.backward(loss)
                 if ids_of[id(p)] in names}
    for p in params.values():
        p.grad = None
    return loss.item(), grads


def _step_errors(loss, grads, loss_p, g_p):
    """A step's loss and gradients against the plain versions', relative
    (gradients by Frobenius norm), and whether they pass the limits."""
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    grad_rel = {n: ((grads[n] - g_p[n]).norm() / g_p[n].norm()).item()
                for n in g_p}
    return {"loss": loss, "loss_rel_diff": loss_rel,
            "grad_rel_diff": grad_rel,
            "ok": loss_rel <= TRAIN_LOSS_RTOL
            and all(r <= TRAIN_GRAD_RTOL for r in grad_rel.values())}


def _captured_step_errors(m, ids, loss_p, g_p):
    """A fresh captured step (lr 0: eager, warm-up, capture + replay,
    all at the same weights) against the plain versions' loss and
    gradients; the gradients are those the replay left in p.grad."""
    from singa_tpu_torch import graph
    graph.reset_graph()
    x = torch.as_tensor(ids, device="cuda")
    for _ in range(3):
        _, loss = m.train_step(x)
    check(m.graph is not None and m.graph.graph is not None,
          "the third train_step did not capture")
    params = m.get_params()
    return _step_errors(loss.item(), {n: params[n].grad for n in GRAD_NAMES},
                        loss_p, g_p)


def phase_train(fault_libs):
    """LlamaConfig.base() training through the user's entry points:
    set_optimizer, compile, train_step, at B=8 x T=1024, bf16
    activations over f32 masters, the step captured as a CUDA graph."""
    from singa_tpu_torch import device, graph, kernel_check, opt
    from singa_tpu_torch.models import Llama, LlamaConfig
    from singa_tpu_torch.ops import flash_attention as fa

    dev = device.create_device("cuda")
    cfg = dataclasses.replace(LlamaConfig.base(), fused_loss=True)
    m = Llama(cfg, device=dev,
              generator=torch.Generator("cuda").manual_seed(0))
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TB, TT)).astype(np.int32)
    batches = [torch.as_tensor(np.random.RandomState(1 + i).randint(
        0, cfg.vocab_size, (TB, TT)).astype(np.int32), device="cuda")
        for i in range(COMPARE_STEPS)]
    x = torch.as_tensor(ids, device="cuda")
    start = {n: p.detach().cpu() for n, p in m.get_params().items()}

    # the same step on the same weights with the plain versions, with the
    # kernels and with each planted fault in place of a kernel, eagerly
    with plain_attention():
        loss_p, g_p = _loss_and_grads(m, ids)
    sound = _step_errors(*_loss_and_grads(m, ids), loss_p, g_p)
    faulty = {}
    for name in TRAIN_FAULTS:
        swap = (kernel_check.flash_kernel if name in kernel_check.FLASH_FAULTS
                else kernel_check.flash_bwd_kernel)
        with swap(fault_libs[name]):
            faulty[name] = _step_errors(*_loss_and_grads(m, ids), loss_p, g_p)
    # and through a captured step, made afresh for each kernel library
    m.set_optimizer(opt.SGD(lr=0.0))
    m.compile([ids], is_train=True, use_graph=True)
    captured_sound = _captured_step_errors(m, ids, loss_p, g_p)
    with kernel_check.flash_bwd_kernel(fault_libs[CAPTURED_FAULT]):
        captured_fault = _captured_step_errors(m, ids, loss_p, g_p)
    graph.reset_graph()                   # the graph kept the fault's kernels
    del g_p

    # from the same initial weights: eager steps, then captured ones; the
    # captured run under a model name of its own, its spans read back
    m.name = NAMED_MODEL
    runs, spans = {}, {}
    for use_graph in (False, True):
        m.set_params(start)
        m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9))
        m.compile([ids], is_train=True, use_graph=use_graph)
        with named_spans() as spans[use_graph]:
            runs[use_graph] = [m.train_step(b)[1].item() for b in batches]
        if not use_graph:
            torch.cuda.reset_peak_memory_stats()
            eager_times = [_timed(lambda: m.train_step(x))[1]
                           for _ in range(EAGER_TIMED)]
            eager_peak = torch.cuda.max_memory_allocated()
            phase_profile(lambda: m.train_step(x),
                          f"one eager train step, B={TB} T={TT}",
                          {k: cfg.num_layers for k in
                           ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
            for p in m.get_params().values():
                p.grad = None
            gc.collect()
            torch.cuda.empty_cache()
    del start
    named = spans[True]
    compare = [abs(c - e) / abs(e) for c, e in zip(runs[True], runs[False])]
    g = m.get_graph("train")

    # the main path: replays of the captured step on a fixed batch
    torch.cuda.reset_peak_memory_stats()
    fa.reset_device_launches()
    times, per_step, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        before = fa.device_launches()
        (_, loss), t = _timed(lambda: m.train_step(x))
        losses.append(loss.item())
        times.append(t)
        after = fa.device_launches()
        per_step.append([after[k] - before[k] for k in fa.KERNELS])
    launches = fa.device_launches()
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times)[len(times) // 2]
    eager_s = sorted(eager_times)[len(eager_times) // 2]
    flops = m.flops_per_token(TT) * TB * TT
    peak_flops = PEAK_FLOPS[torch.bfloat16]
    result = {
        "phase": "train", "config": "LlamaConfig.base(), fused_loss=True",
        "optimizer": "SGD(lr=0.01, momentum=0.9)", "params": m.num_params(),
        "B": TB, "T": TT, "captured": g.graph is not None,
        "capture_s": g.capture_seconds, "graph_num_ops": g.num_ops,
        "graph_flops": g.flops(), "graph_pool_bytes": g.pool_bytes,
        "graph_launches": g.launches,
        "timed_steps": TRAIN_STEPS, "step_ms": [t * 1e3 for t in times],
        "median_step_ms": step_s * 1e3, "tokens_per_s": TB * TT / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / peak_flops,
        "peak_memory_bytes": peak,
        "reserved_bytes": torch.cuda.memory_reserved(),
        "losses": losses, "launches": launches,
        "launches_per_step": per_step, "expected_per_step": cfg.num_layers,
        "eager": {"step_ms": [t * 1e3 for t in eager_times],
                  "median_step_ms": eager_s * 1e3,
                  "tokens_per_s": TB * TT / eager_s,
                  "mfu": flops / eager_s / peak_flops,
                  "peak_memory_bytes": eager_peak},
        "eager_vs_captured": {"eager_losses": runs[False],
                              "captured_losses": runs[True],
                              "rel_diff": compare,
                              "bitwise": runs[False] == runs[True],
                              "loss_rtol": TRAIN_LOSS_RTOL},
        "kernel_vs_plain": {**sound, "loss_plain": loss_p,
                            "loss_rtol": TRAIN_LOSS_RTOL,
                            "grad_rtol": TRAIN_GRAD_RTOL},
        "faults_vs_plain": faulty,
        "captured_vs_plain": captured_sound,
        "captured_fault_vs_plain": {CAPTURED_FAULT: captured_fault},
        "named_model": named,
    }
    emit(result)
    SUMMARY["train"] = {k: result[k] for k in (
        "optimizer", "median_step_ms", "tokens_per_s", "mfu",
        "peak_memory_bytes", "graph_pool_bytes")}
    check(result["captured"], "train_step did not run a captured graph")
    want = f"{NAMED_MODEL}.train"
    check(named["model.train_step"] == [NAMED_MODEL] * COMPARE_STEPS
          and named["graph.compile"] == [want]
          and named["graph.execute"] == [want] * COMPARE_STEPS
          and g.name == want
          and all(n > 0 for n in named["flash_launches"].values()),
          f"the captured step of a model named {NAMED_MODEL!r} recorded "
          f"{named}, its graph {g.name!r}, not model={NAMED_MODEL!r} and "
          f"graph={want!r} over flash launches")
    check(g.launches == {k: cfg.num_layers for k in launches},
          f"the train graph holds {g.launches}")
    check(all(s == [cfg.num_layers] * 3 for s in per_step),
          f"flash kernels launched {per_step} times per step, expected "
          f"{cfg.num_layers} each")
    check(max(compare) <= TRAIN_LOSS_RTOL,
          f"captured losses {runs[True]} differ from eager {runs[False]}")
    check(np.isfinite(losses).all(), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(p.dtype == torch.float32 for p in m.get_params().values()),
          "masters are not f32")
    check(sound["ok"], f"loss or gradients with the kernels differ from "
          f"plain ({loss_p}): {sound}")
    check(captured_sound["ok"], f"the captured step differs from plain: "
          f"{captured_sound}")
    missed = [n for n in TRAIN_FAULTS if faulty[n]["ok"]]
    check(not missed, f"planted faults pass the step's limits: {missed}")
    check(not captured_fault["ok"], f"{CAPTURED_FAULT} passes the step's "
          f"limits through a captured step: {captured_fault}")
    phase_profile(lambda: m.train_step(x),
                  f"one replayed train step, B={TB} T={TT}",
                  {k: cfg.num_layers for k in launches})
    return launches


@contextmanager
def named_spans():
    """Within the block, obs events go to a temporary file; after it the
    dict yielded holds each ``model.train_step`` span's ``model``, each
    ``graph.compile`` and ``graph.execute`` span's ``graph`` in order,
    and the flash kernels' launches on the card over the block."""
    from singa_tpu_torch.obs import events
    from singa_tpu_torch.ops import flash_attention as fa
    out = {}
    before = fa.device_launches()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "events.jsonl"
        events.configure(path=str(path))
        try:
            yield out
        finally:
            events.configure()
        spans = [e for e in map(json.loads, path.read_text().splitlines())
                 if e.get("kind") == "span"]
    key = {"model.train_step": "model", "graph.compile": "graph",
           "graph.execute": "graph"}
    out.update({n: [e.get(k) for e in spans if e["name"] == n]
                for n, k in key.items()})
    after = fa.device_launches()
    out["flash_launches"] = {k: after[k] - before[k] for k in fa.KERNELS}


def phase_checkpoint():
    """Save after step CKPT_SAVE_AFTER of a captured run, load into a
    fresh model, run the remaining steps: the losses must equal the
    uninterrupted run's.  LlamaConfig.base() at its widths, cut to
    CKPT_LAYERS layers."""
    from singa_tpu_torch import device, opt
    from singa_tpu_torch.models import Llama, LlamaConfig

    dev = device.create_device("cuda")
    cfg = dataclasses.replace(LlamaConfig.base(), fused_loss=True,
                              num_layers=CKPT_LAYERS)
    rng = np.random.RandomState(11)
    batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (TB, TT))
                               .astype(np.int32), device="cuda")
               for _ in range(CKPT_STEPS)]
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt.npz"

    def model(seed):
        m = Llama(cfg, device=dev,
                  generator=torch.Generator("cuda").manual_seed(seed))
        m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9))
        m.compile([batches[0]], is_train=True, use_graph=True)
        return m

    m = model(0)
    whole = []
    for i, b in enumerate(batches):
        whole.append(m.train_step(b)[1].item())
        if i + 1 == CKPT_SAVE_AFTER:
            _, save_s = _timed(lambda: m.save_states(str(path)))
    del m
    gc.collect()
    torch.cuda.empty_cache()
    m = model(1)
    try:
        _, load_s = _timed(lambda: m.load_states(str(path)))
        file_bytes = path.stat().st_size
    finally:
        path.unlink()
    resumed = [m.train_step(b)[1].item() for b in batches[CKPT_SAVE_AFTER:]]
    rel = [abs(r - w) / abs(w) for r, w in zip(resumed,
                                                whole[CKPT_SAVE_AFTER:])]
    emit({"phase": "checkpoint",
          "config": f"LlamaConfig.base(), fused_loss=True, num_layers="
                    f"{CKPT_LAYERS}", "params": m.num_params(),
          "saved_after_step": CKPT_SAVE_AFTER, "file_bytes": file_bytes,
          "save_s": save_s, "load_s": load_s,
          "uninterrupted_losses": whole, "resumed_losses": resumed,
          "rel_diff": rel, "bitwise": resumed == whole[CKPT_SAVE_AFTER:],
          "loss_rtol": TRAIN_LOSS_RTOL,
          "resumed_captured": m.graph.graph is not None})
    check(max(rel) <= TRAIN_LOSS_RTOL,
          f"resumed losses {resumed} differ from {whole}")
    check(m.graph.graph is not None, "the resumed run did not capture")


# -- the load, banded and moe phases -----------------------------------------


def load_run(eng, closed_tps, closed_tokens, what, obsq=False):
    """The open-loop load generator (singa_tpu_torch.tools.loadgen) through
    `eng`: LOAD_REQUESTS Poisson arrivals at LOAD_RATE_SHARE of the closed
    wave's request rate (its tokens/s over its tokens per request), the
    engine's counters and the card's launch counters zeroed first.  The
    payload goes to the port's record store as a serve_load entry.  With
    `obsq`, the run's events go to a JSONL sink (SINGA_OBS's) beside
    that store, and the port's obsq is held to the record
    (`load_obsq`)."""
    from singa_tpu_torch.obs import events as obs_events
    from singa_tpu_torch.obs import record as obs_record
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.serve.metrics import ServeMetrics
    from singa_tpu_torch.tools import loadgen

    rate = LOAD_RATE_SHARE * closed_tps / closed_tokens
    wl = loadgen.build_workload(LOAD_REQUESTS, rate, LOAD_SEED,
                                vocab=eng.model.cfg.vocab_size,
                                **loadgen.CHAT_WORKLOAD)
    eng.metrics = ServeMetrics(flight=eng.flight)
    with tempfile.TemporaryDirectory() as d:
        events = str(Path(d) / "ev.jsonl")
        if obsq:
            obs_events.configure(path=events)
        fa.reset_device_launches()
        try:
            payload = loadgen.run_load(eng, wl)
        finally:
            launches = fa.device_launches()
            if obsq:
                obs_events.configure()
        store = loadgen.append_record(payload, str(Path(d) / "r.jsonl"),
                                      device="cuda", prefix=f"load-{what}")
        record_errors = obs_record.RunRecord(store).validate()
        queried = load_obsq(store, events, d) if obsq else None
    out = {"engine": what, "rate_rps": rate,
           "closed_wave_tokens_per_s": closed_tps,
           "closed_wave_tokens_per_request": closed_tokens,
           "workload": {"requests": LOAD_REQUESTS, "seed": LOAD_SEED,
                        **loadgen.CHAT_WORKLOAD},
           "arrivals_s": [wl[0].at_s, wl[-1].at_s], "payload": payload,
           "flash_launches": launches, "record_errors": record_errors}
    emit({"phase": "load", **out})
    p = payload
    check(p["completed"] + p["shed"] + p["rejected"] == LOAD_REQUESTS
          and p["completed"] > 0, f"the load run lost requests: {p}")
    check(launches == dict.fromkeys(fa.KERNELS, 0),
          f"the flash kernels ran {launches} times under the load run")
    check(not record_errors, f"the serve_load record: {record_errors}")
    if queried is not None:
        emit({"phase": "load", "obsq": queried})
        for cond, msg in queried.pop("checks"):
            check(cond, msg)
    return out


def _obsq(argv):
    """(exit code, stdout, stderr) of the port's obsq on `argv`, run in
    this process as `python -m singa_tpu_torch.tools.obsq` runs it."""
    from singa_tpu_torch.tools import obsq
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = obsq.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def load_obsq(store, events, tmp):
    """The port's obsq over a load run's serve_load record and the events
    it emitted: `slo --check` must exit 0; a store holding the record and
    a planted copy of it with ttft_p99_ms raised by LOAD_PLANT (the
    newest, so the one checked) must exit 1; `trace` of one request
    must show its submission, its prefill span, then its tokens in
    order; `diff serve_load` over the planted store must give a row per
    record and the change between them."""
    from singa_tpu_torch.obs import record as obs_record
    from singa_tpu_torch.tools import obsq

    t0 = time.perf_counter()
    slo = _obsq(["slo", "--check", "--records", store, "--events", events])
    entry = obs_record.RunRecord(store).entries()[-1]
    planted = json.loads(json.dumps(entry))
    planted["run_id"] += "-planted"
    planted["payload"]["ttft_p99_ms"] = round(
        entry["payload"]["ttft_p99_ms"] * (1 + LOAD_PLANT), 3)
    planted_store = str(Path(tmp) / "planted.jsonl")
    rr = obs_record.RunRecord(planted_store)
    rr.append(entry)
    rr.append(planted)
    slo_planted = _obsq(["slo", "--check", "--records", planted_store,
                         "--events", events])
    evs = obsq.load_events(events)
    tids = sorted({e["trace"] for e in evs
                   if e.get("name") == "serve.ttft_ms"})
    mine = obsq.trace_events(evs, tids[0])
    trace = _obsq(["trace", tids[0], "--events", events])
    diff = _obsq(["diff", "serve_load", "--records", planted_store,
                  "--fields", "tokens_per_s,ttft_p50_ms,ttft_p99_ms"])
    _, rows = obsq.diff_rows(planted_store, "serve_load")
    names = [e["name"] for e in mine]
    tokens = [e["n"] for e in mine if e["name"] == "serve.token"]
    out = {"events": len(evs), "traces_with_first_token": len(tids),
           "slo_check": {"rc": slo[0], "stdout": slo[1].splitlines(),
                         "stderr": slo[2].splitlines()},
           "planted": {"raise": LOAD_PLANT, "rc": slo_planted[0],
                       "stderr": slo_planted[2].splitlines()},
           "trace": {"id": tids[0], "rc": trace[0],
                     "lines": trace[1].splitlines()},
           "diff": {"rc": diff[0], "lines": diff[1].splitlines()},
           "seconds": time.perf_counter() - t0}
    out["checks"] = [
        (slo[0] == 0, f"obsq slo --check exits {slo[0]} on the load "
                      f"record: {slo[2]}"),
        (slo_planted[0] == 1 and "ttft_p99_ms" in slo_planted[2],
         f"obsq slo --check exits {slo_planted[0]} on the planted "
         f"record: {slo_planted[2]}"),
        (len(tids) == entry["payload"]["completed"],
         f"{len(tids)} traces carry a first token, "
         f"{entry['payload']['completed']} requests completed"),
        (trace[0] == 0 and names[0] == "serve.submitted"
         and "serve.prefill" in names and "serve.token" in names
         and names.index("serve.prefill") < names.index("serve.token")
         and tokens == list(range(1, len(tokens) + 1)),
         f"obsq trace {tids[0]}: {names}"),
        (diff[0] == 0 and len(rows) == 3 and rows[-1][0].startswith("Δ"),
         f"obsq diff serve_load: {diff}")]
    return out


def phase_load(m, ctx):
    """The load generator through the serve phase's engine configuration
    over base(), at 0.8 x the serve phase's closed-wave request rate,
    its record and events queried through the port's obsq."""
    eng, _ = serve_engine(m)
    out = load_run(eng, ctx["tokens_per_s"], SERVE_NEW, "base", obsq=True)
    eng.close()
    return out["flash_launches"]


def _ops_cut():
    """(configuration, layers) of the autotuner's card sweep: the
    model the ops phase serves and trains."""
    from singa_tpu_torch.tools import autotune as at_cli
    return at_cli.CARD_SWEEP["config"], at_cli.CARD_SWEEP["layers"]


def _ops_model():
    """The card sweep's model on the card, seed 0 (its table keys are
    llama-d2048-L2 and llama-d2048-L2-dp1)."""
    from singa_tpu_torch import device
    from singa_tpu_torch.tools import loadgen
    return loadgen.tier_model(device.create_device("cuda"), *_ops_cut())


def ops_table(later, m):
    """The committed best-config table, validated with the port's store,
    and each swept knob of the ops phase's models (`m` and its training
    cell) resolved from its committed cuda entry: {domain: {"key",
    "knobs", "card", ...}}."""
    from singa_tpu_torch.autotune import table
    from singa_tpu_torch.tools import autotune as at_cli

    store = str(Path(__file__).resolve().parent / at_cli.STORE)
    errors = at_cli.check_errors(store)
    later(not errors, f"the committed table or its records: {errors}")
    doc = table.load_table(required=True)
    model_key = table.model_key(m)
    out = {}
    for domain, key, swept in (
            ("serve", model_key, ("num_slots", "block_size", "spec_k")),
            ("train", at_cli.train_model_key(*_ops_cut()),
             ("batch", "ce_chunk", "int8_ring"))):
        entry = doc["configs"].get(table.config_key(domain, key, "cuda"))
        check(entry is not None, f"no committed cuda entry for "
              f"{domain}/{key}: {sorted(doc['configs'])}")
        resolved = table.resolve(domain, key, "cuda", {})
        knobs = {k: resolved[k] for k in swept}
        later(all(k in entry["knobs"] and entry["knobs"][k] == v
                  for k, v in knobs.items()),
              f"{domain}/{key}: resolved {knobs} not from the committed "
              f"entry {entry['knobs']}")
        out[domain] = {"key": table.config_key(domain, key, "cuda"),
                       "knobs": knobs, "objective": entry["objective"],
                       "objective_name": entry["objective_name"],
                       "loo_rel_err": entry["loo_rel_err"],
                       "card": entry.get("card"),
                       "run_id": entry["run_id"]}
        later(entry.get("card"), f"{domain}/{key}: the entry names no "
              f"card and power limit")
    later(not any(k.endswith("/tpu") for k in doc["configs"]),
          "a table entry is keyed tpu")
    return out


def ops_smokes(later):
    """Three of loadgen's four smokes on the card sweep's model,
    on the card, in f32 (their streams held bitwise to generate() and
    to a single engine): their return codes and walls.  The fourth, the
    mp smoke, runs in a process of its own (`OpsProcs`)."""
    from singa_tpu_torch.tools import loadgen
    out = {}
    for name in ("spec", "spill", "disagg"):
        fn = getattr(loadgen, f"{name}_smoke")
        t = time.perf_counter()
        rc = fn(*_ops_cut(), "cuda")
        out[name] = {"rc": rc, "seconds": time.perf_counter() - t}
        _free()
        later(rc == 0, f"{name}_smoke failed on the card (rc {rc})")
    return out


def ops_spec_compare(later, tmp):
    """One --spec-compare pair through the CLI's function (bf16 weights,
    the table's arena knobs, the CLI's other defaults), both records
    read back and validated.  The spec side's accept rate is reported,
    not held to 1.0: in bf16 the draft's one-token steps and the
    target's (S, k+1) window round differently, so a near-tie can part
    them (the smoke holds 1.0 in f32)."""
    from singa_tpu_torch.obs import record as obs_record
    from singa_tpu_torch.obs import schema
    from singa_tpu_torch.tools import loadgen

    store = str(tmp / "spec_pair.jsonl")
    config, layers = _ops_cut()
    args = loadgen._parser().parse_args([
        "--config", config, "--layers", str(layers), "--device", "cuda",
        "--spec-k", str(SPEC_K), "--max-len", str(OPS_PAIR["max_len"]),
        "--requests", str(OPS_PAIR["requests"]),
        "--rate", str(OPS_PAIR["rate"]), "--deadline", "300",
        "--prompt-lens", ",".join(map(str, OPS_PAIR["prompt_lens"])),
        "--new-tokens", ",".join(map(str, OPS_PAIR["new_tokens"]))])
    t = time.perf_counter()
    rows = loadgen.spec_compare(args, store, trials=OPS_PAIR["trials"])
    seconds = time.perf_counter() - t
    _free()
    entries = obs_record.RunRecord(store).entries()
    for e in entries:
        schema.validate_entry(e)
    pair = {r["spec_pair_id"] for r in rows}
    later(len(entries) == 2 and len(pair) == 1
          and all(e["payload"]["spec_pair_id"] in pair for e in entries)
          and all(r["completed"] == r["requests"] for r in rows),
          f"the spec pair's records: {entries}")
    keep = ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "completed",
            "accept_rate", "tokens_per_dispatch", "spec_k")
    return {"knobs": {"num_slots": args.num_slots,
                      "block_size": args.block_size},
            "plain": {k: rows[0][k] for k in keep if k in rows[0]},
            "spec": {k: rows[1][k] for k in keep if k in rows[1]},
            "workload": OPS_PAIR, "seconds": seconds}


def ops_perf_attr(later, m, knobs):
    """A load run through an engine at the table's serve knobs with the
    attribution ledger installed, and its perf_attr payload built and
    validated (obs.cost.perf_attr_payload; any error fails the
    phase)."""
    from singa_tpu_torch.obs import attr as obs_attr
    from singa_tpu_torch.obs import cost as obs_cost
    from singa_tpu_torch.obs import schema
    from singa_tpu_torch.serve import ServeEngine
    from singa_tpu_torch.serve.metrics import ServeMetrics
    from singa_tpu_torch.tools import loadgen

    eng = ServeEngine(m, knobs["num_slots"], OPS_PAIR["max_len"],
                      block_size=knobs["block_size"],
                      param_dtype=torch.bfloat16)
    try:
        loadgen._warm(eng, m.cfg.vocab_size, 0)
        eng.metrics = ServeMetrics(flight=eng.flight)
        wl = loadgen.build_workload(
            OPS_PAIR["requests"], OPS_PAIR["rate"], 0,
            prompt_lens=OPS_PAIR["prompt_lens"],
            new_tokens=OPS_PAIR["new_tokens"], vocab=m.cfg.vocab_size)
        led = obs_attr.install()
        try:
            load = loadgen.run_load(eng, wl)
        finally:
            obs_attr.uninstall()
        payload = obs_cost.perf_attr_payload(led.snapshot(), eng,
                                             load["detail"]["wall_s"])
    finally:
        eng.close()
    schema.validate_perf_attr_payload(payload)
    later(0.0 < payload["attributed_frac"] <= 1.0
          and {"prefill_chunk", "decode"} <= payload["programs"].keys(),
          f"the perf_attr payload: {payload}")
    return {"load": {k: load[k] for k in ("completed", "tokens_per_s",
                                          "ttft_p50_ms", "ttft_p99_ms")},
            "perf_attr": payload}


class _Beside:
    """A command run beside the phases that follow it, in a session of
    its own from the repository's root: its output and its seconds are
    read on a thread.  `stop()` ends it and every process it started."""

    def __init__(self, argv):
        import threading
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            argv, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self.out, self.seconds = "", None
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        self.out = self.proc.communicate()[0]
        self.seconds = time.perf_counter() - self.t0

    def wait(self, timeout):
        """Its exit code once it ends (None if `timeout` passes first, and
        then it is stopped)."""
        self.thread.join(timeout)
        if self.thread.is_alive():
            self.stop()
            self.thread.join()
            return None
        return self.proc.returncode

    def stop(self):
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


class OpsProcs:
    """The ops phase's two smokes over process tiers, each in an
    interpreter of its own, started before phase ops and read after
    phase beam, so their workers' starts and the chaos smoke's
    detection deadlines overlap phases ops, spec, mem, disagg and beam.
    Their engines and tiers capture their CUDA graphs in their own
    processes, apart from this one's.
    - mp: loadgen's ``--mp-smoke`` on the card sweep's model in
      f32 (a 2-process 1:1 tier's streams bitwise a single engine's);
    - chaos: `ops_chaos_child`, the chaos smoke on the card: 1 SIGKILL
      and 1 SIGSTOP on a 1:1 process tier of the card sweep's model
      (bf16 weights), every stream bitwise the single engine's, no
      orphan, every worker's programs within (1, 1); the detection and
      respawn seconds."""

    def __init__(self):
        config, layers = _ops_cut()
        self.tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ops_"))
        self.procs = {
            "mp": _Beside([sys.executable, "-m",
                           "singa_tpu_torch.tools.loadgen", "--mp-smoke",
                           "--config", config, "--layers", str(layers),
                           "--device", "cuda"]),
            "chaos": _Beside([sys.executable, "-c",
                              "import sys, chip_smoke as c; "
                              "sys.exit(c.ops_chaos_child(sys.argv[1]))",
                              str(self.tmp / "chaos.jsonl")])}

    def stop(self):
        import shutil
        for p in self.procs.values():
            p.stop()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def finish(self):
        """Wait for both; print their results as a line of phase ops, then
        hold them."""
        try:
            rcs = {n: p.wait(OPS_PROCS_TIMEOUT_S)
                   for n, p in self.procs.items()}
        finally:
            self.stop()
        mp, chaos = self.procs["mp"], self.procs["chaos"]
        res = {}
        for line in chaos.out.splitlines():
            try:
                res = json.loads(line).get("chaos_result", res)
            except ValueError:
                continue
        emit({"phase": "ops", "beside": "spec, mem, disagg and beam",
              "smokes": {"mp": {"rc": rcs["mp"], "seconds": mp.seconds}},
              "chaos_smoke": {**res, "rc": rcs["chaos"],
                              "process_seconds": chaos.seconds}})
        check(rcs["mp"] == 0, f"mp_smoke failed on the card (rc "
              f"{rcs['mp']}): {mp.out[-3000:]}")
        check(rcs["chaos"] == 0 and res and not res["problems"],
              f"the chaos smoke on the card (rc {rcs['chaos']}): "
              f"{res.get('problems')} {chaos.out[-3000:]}")


class NetBeside:
    """Phase net (`phase_net`, the process tier) in an interpreter of its
    own, started after phase disagg with the serve phase's first wave
    and its streams, and read after phase tensor: its workers' starts,
    its waves and its respawn overlap phases beam, hf, checkpoint and
    tensor.  Its lines are printed here when it has ended."""

    def __init__(self, ctx):
        self.tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_net_"))
        path = self.tmp / "ctx.json"
        path.write_text(json.dumps({
            "prompts": [p.tolist() for p in ctx["prompts"][:SERVE_SLOTS]],
            "wave": [list(map(int, t)) for t in ctx["wave"]],
            "plain_wave": {"seconds": ctx["plain_wave"]["seconds"]}}))
        self.proc = _Beside([sys.executable, "-c",
                             "import sys, chip_smoke as c; "
                             "sys.exit(c.net_child(sys.argv[1]))",
                             str(path)])

    def stop(self):
        import shutil
        self.proc.stop()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def finish(self):
        try:
            rc = self.proc.wait(NET_SPAWN_TIMEOUT_S)
        finally:
            self.stop()
        for line in self.proc.out.splitlines():
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and obj.get("phase") == "net":
                emit({**obj, "process_seconds": self.proc.seconds})
        check(rc == 0, f"phase net failed (rc {rc}): "
              f"{self.proc.out[-3000:]}")


def net_child(path):
    """Phase net in a fresh interpreter (`NetBeside`): the serve phase's
    first wave and its streams read from the JSON file at `path`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = json.loads(Path(path).read_text())
    ctx["prompts"] = [np.asarray(p, np.int32) for p in ctx["prompts"]]
    phase_net(ctx)
    return 0


def ops_chaos_child(store):
    """The chaos smoke in a fresh interpreter (`OpsProcs`): chaosd's
    run_smoke on the card over the card sweep's model, records to
    `store`; its result as a JSON line."""
    from singa_tpu_torch.tools import chaosd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, layers = _ops_cut()
    t = time.perf_counter()
    fails, res = chaosd.run_smoke(store, config=config, layers=layers,
                                  device="cuda")
    emit({"chaos_result": {
        "payload": res["payload"], "timings": res["timings"],
        "problems": fails, "seconds": time.perf_counter() - t,
        "op_timeouts": chaosd.CHAOS_OP_TIMEOUTS,
        "compile_timeout_s": chaosd.CHAOS_COMPILE_TIMEOUT_S}})
    return 0


def ops_best_serve(m, serve):
    """One fresh measurement of the table's best serve point, through
    the autotuner's own measure under the card sweep's workload, beside
    the recorded objective.  Not a gate."""
    from singa_tpu_torch.tools import autotune as at_cli
    d = at_cli.sweep_defaults("cuda", "serve")
    measure = at_cli.serve_measure(
        m, requests=d["requests"], rate=d["rate"], seed=0,
        max_len=d["max_len"], deadline=300.0, trials=d["trials"],
        workload=d["workload"])
    t = time.perf_counter()
    tps, feats = measure(serve["knobs"])
    return {"knobs": serve["knobs"], "tokens_per_s": tps,
            "recorded_tokens_per_s": serve["objective"],
            "ratio": tps / serve["objective"], "features": feats,
            "seconds": time.perf_counter() - t}


def ops_train_point(later, train):
    """The table's best train point through the autotuner's measure on
    an NCCL group of one, at the card sweep's model, T and steps (T =
    1024), its flash launches over the timed replays counted on the card
    (each kernel once per layer per step)."""
    from singa_tpu_torch import device
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.tools import autotune as at_cli
    dev = device.create_device("cuda")
    launches = []
    d = at_cli.sweep_defaults("cuda", "train")
    measure = at_cli.train_measure(dev, config=d["config"],
                                   layers=d["layers"], seq=d["seq"],
                                   steps=d["steps"], launches=launches)
    with at_cli._group_of_one(dev):
        step_ms, feats = measure(train["knobs"])
    expect = dict.fromkeys(fa.KERNELS, d["layers"] * d["steps"])
    later(launches == [expect], f"the train point's flash launches "
          f"{launches}, expected {expect}")
    later(not torch.distributed.is_initialized(), "the group outlived "
          "the train point")
    return {"knobs": train["knobs"], "step_ms": step_ms,
            "recorded_step_ms": train["objective"], "features": feats,
            "launches": launches[0], "steps": d["steps"], "T": d["seq"]}


def phase_ops():
    """The serving operator's tools on the card: the committed
    best-config table resolved for the card sweep's model, three of
    loadgen's smokes, a --spec-compare pair, a perf_attr payload, a
    fresh measurement of the table's best serve point, and its best
    train point with its flash launches.  The mp and chaos smokes run
    in processes of their own (`OpsProcs`), read after phase beam."""
    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        m = _ops_model()
        table = ops_table(later, m)
        smokes = ops_smokes(later)
        pair = ops_spec_compare(later, tmp)
        attr_run = ops_perf_attr(later, m, table["serve"]["knobs"])
        _free()
        best = ops_best_serve(m, table["serve"])
        del m
        _free()
        train = ops_train_point(later, table["train"])
        _free()
    config, layers = _ops_cut()
    emit({"phase": "ops", "config": f"LlamaConfig.{config}() cut to "
          f"{layers} layers", "table": table, "smokes": smokes,
          "spec_compare": pair, "perf_attr": attr_run,
          "attributed_frac": attr_run["perf_attr"]["attributed_frac"],
          "best_serve_point": best, "train_point": train,
          "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return train["launches"], train["steps"]


def config_model(cfg):
    """`cfg` on the card, f32 masters from seed 0."""
    from singa_tpu_torch import device
    from singa_tpu_torch.models import Llama
    return Llama(cfg, device=device.create_device("cuda"),
                 generator=torch.Generator("cuda").manual_seed(0))


def _token_batch(rng, vocab, b, t):
    """One (b, t) batch of token ids on the card: a causal LM's input."""
    return (torch.as_tensor(rng.randint(0, vocab, (b, t)).astype(np.int32),
                            device="cuda"),)


def _opt_name(o) -> str:
    """An optimizer as the records name it."""
    from singa_tpu_torch import opt
    if isinstance(o, opt.DistOpt):
        kw = {k: getattr(o, k) for k in ("compression", "compress_dtype",
                                         "topk_ratio", "shard_weight_update")
              if getattr(o, k)}
        return f"DistOpt({_opt_name(o.opt)}, {kw})"
    if isinstance(o, opt.SGD):
        return (f"SGD(lr={o.sched.lr}, momentum={o.momentum}, "
                f"weight_decay={o.weight_decay})")
    return type(o).__name__


def config_train(m, b, t, later, expect, flops_per_token=None,
                 make_batch=_token_batch, cfg=None, make_opt=None):
    """A configuration's training through set_optimizer / compile /
    train_step (SGD momentum 0.9): CONFIG_STEPS eager and captured steps
    from the same weights, batches (`make_batch(rng, vocab, b, t)`: the
    train_step arguments) and dropout generator seed, their losses and
    the parameters after them held to each other bitwise (the captured
    run's second, warm-up call runs under set_sync_debug_mode("error"));
    then TRAIN_STEPS timed replays on a fixed batch, each kernel's
    launches counted on the card per step, which must be `expect` each.
    `hfu_graph` counts the captured graph's own FLOPs (what the card
    ran: recomputations included, the flash kernels' left out); `mfu`
    counts `flops_per_token`, the model's own FLOPs, where the caller
    gives them.  An MoE model's aux loss is read at every step: the
    tensor its capture recorded is rewritten by each replay.  `cfg`
    stands in for a model without one (an ONNX import); `make_opt` makes
    the optimizer of each run (default SGD(0.01, momentum 0.9))."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import _dropout_generators
    from singa_tpu_torch.ops import flash_attention as fa

    make_opt = make_opt or (lambda: opt.SGD(lr=0.01, momentum=0.9))
    cfg = cfg or m.cfg
    moe = getattr(cfg, "num_experts", 0)
    rng = np.random.RandomState(0)
    batches = [make_batch(rng, cfg.vocab_size, b, t)
               for _ in range(CONFIG_STEPS)]
    x = batches[0]
    start = {n: p.detach().cpu() for n, p in m.get_params().items()}
    dropout = _dropout_generators(m)
    aux_seen = []
    if moe:
        pop = m._moe_aux_loss

        def recorded():
            # kept detached: a loss's autograd graph held across steps
            # keeps its AccumulateGrad nodes on the stream of the step
            # that made them, and the capture's backward would sync
            # with it
            aux = pop()
            aux_seen.append(aux.detach())
            return aux
        m._moe_aux_loss = recorded
    torch.cuda.reset_peak_memory_stats()
    runs, aux_runs = {}, {}
    for use_graph in (False, True):
        m.set_params(start)
        for gen in dropout:
            gen.manual_seed(0)
        m.set_optimizer(make_opt())
        m.compile(list(x), is_train=True, use_graph=use_graph)
        losses, aux = [], []
        for i, bt in enumerate(batches):
            if use_graph and i == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                _, loss = m.train_step(*bt)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            losses.append(loss.item())
            if aux_seen:
                aux.append(aux_seen[-1].item())
        runs[use_graph], aux_runs[use_graph] = losses, aux
        if not use_graph:
            eager_end = {n: p.detach().cpu()
                         for n, p in m.get_params().items()}
    del start
    # one parameter at a time: the host holds one copy of the weights
    # here, not two
    differ = [n for n, p in m.get_params().items()
              if not torch.equal(p.detach().cpu(), eager_end[n])]
    del eager_end
    g = m.get_graph("train")
    fa.reset_device_launches()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, per_step, losses, aux = [], [], [], []
    for _ in range(TRAIN_STEPS):
        before = fa.device_launches()
        (_, loss), dt = _timed(lambda: m.train_step(*x))
        losses.append(loss.item())
        times.append(dt)
        if aux_seen:
            aux.append(aux_seen[-1].item())
        after = fa.device_launches()
        per_step.append([after[k] - before[k] for k in fa.KERNELS])
    launches = fa.device_launches()
    replay_peak = torch.cuda.max_memory_allocated()
    peak = max(peak, replay_peak)
    if moe:
        del m._moe_aux_loss
    step_s = sorted(times)[len(times) // 2]
    peak_rate = PEAK_FLOPS[torch.bfloat16]
    out = {
        "B": b, "T": t, "optimizer": _opt_name(m.optimizer),
        "fused_loss": getattr(cfg, "fused_loss", None),
        "captured": g.graph is not None,
        "capture_s": g.capture_seconds, "graph_num_ops": g.num_ops,
        "graph_flops": g.flops(),
        "graph_pool_bytes": g.pool_bytes, "graph_launches": g.launches,
        "step_ms": [dt * 1e3 for dt in times],
        "median_step_ms": step_s * 1e3, "tokens_per_s": b * t / step_s,
        "samples_per_s": b / step_s,
        "hfu_graph": g.flops() / step_s / peak_rate,
        "peak_memory_bytes": peak, "replay_peak_memory_bytes": replay_peak,
        "losses": losses, "launches": launches, "launches_per_step": per_step,
        "expected_per_step": expect,
        "eager_vs_captured": {"steps": CONFIG_STEPS,
                              "eager_losses": runs[False],
                              "captured_losses": runs[True],
                              "bitwise": runs[False] == runs[True],
                              "eager_aux": aux_runs[False],
                              "captured_aux": aux_runs[True],
                              "states_bitwise": not differ,
                              "states_differing": differ[:8]},
        "sync_free_warm_up": True}
    if flops_per_token is not None:
        out["flops_per_token"] = flops_per_token
        out["flops_per_step"] = flops_per_token * b * t
        out["mfu"] = flops_per_token * b * t / step_s / peak_rate
    later(not differ, f"captured parameters differ from eager: "
          f"{differ[:8]}")
    if moe:
        out["aux_loss_per_step"] = aux
        out["aux_weight"] = cfg.moe_aux_weight
    later(out["captured"], "train_step did not run a captured graph")
    later(all(s == [expect] * 3 for s in per_step),
          f"flash kernels launched {per_step} times per step, expected "
          f"{expect} each")
    later(out["eager_vs_captured"]["bitwise"], f"captured losses "
          f"{runs[True]} differ from eager {runs[False]}")
    later(np.isfinite(losses).all(), f"non-finite loss: {losses}")
    later(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return out


def config_generate(m, b, p, n, later):
    """generate() at (B, P, N) with bf16 weights: eager beside captured
    (tokens held bitwise), the flash forward's launches counted on the
    card over the captured call, prefill and decode times."""
    from singa_tpu_torch.ops import flash_attention as fa

    cfg = m.cfg
    prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, (b, p))
    kw = dict(max_new_tokens=n, param_dtype=torch.bfloat16)
    m.generate(prompts, use_graph=False, **kw)
    out_eager, eager_s = _timed(lambda: m.generate(prompts, use_graph=False,
                                                   **kw))
    m.generate(prompts, **kw)                      # eager first call
    m.generate(prompts, **kw)                      # capture
    torch.cuda.reset_peak_memory_stats()
    fa.reset_device_launches()
    out, gen_s = _timed(lambda: m.generate(prompts, **kw))
    launches = fa.device_launches()
    peak = torch.cuda.max_memory_allocated()
    graphs = m._gen_sessions[(b, p, p + n, torch.bfloat16,
                              (0.0, None, None, None))].graphs
    prefill_ms = _median_ms(graphs["prefill"].replay)
    expect = {"flash_fwd": cfg.num_layers, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0}
    res = {"B": b, "P": p, "N": n, "param_dtype": "bfloat16",
           "captured": graphs["decode"].graph is not None,
           "generate_ms": gen_s * 1e3, "prefill_ms": prefill_ms,
           "decode_ms_per_token": (gen_s * 1e3 - prefill_ms) / (n - 1),
           "tokens_per_s": b * n / gen_s, "eager_generate_ms": eager_s * 1e3,
           "tokens_equal_eager": bool((out == out_eager).all()),
           "launches": launches, "expected_launches": expect,
           "peak_memory_bytes": peak}
    later(res["captured"], "generate() did not run captured graphs")
    later(launches == expect, f"the kernels ran {launches} times in a "
          f"generate call, expected {expect}")
    later(res["tokens_equal_eager"],
          "captured greedy tokens differ from the eager call's")
    later(out.shape == (b, p + n) and (out[:, :p] == prompts).all()
          and ((out >= 0) & (out < cfg.vocab_size)).all(),
          "generate returned a wrong shape, prompt or token")
    return res


@contextmanager
def route_trace():
    """While open, every `ops.moe._route` call appends its router
    probabilities (N, E), f32, to the yielded list.  Only eager calls
    are seen: a CUDA-graph replay runs no Python."""
    from singa_tpu_torch.ops import moe
    calls = []
    saved = moe._route

    def traced(logits, capacity, k, grid=None):
        out = saved(logits, capacity, k, grid)
        calls.append(out[4].detach().clone())
        return out
    moe._route = traced
    try:
        yield calls
    finally:
        moe._route = saved


def moe_row_probe(c, params, sizes):
    """Whether a token's MoE output depends on the rows routed beside it
    at the sizes the serving paths run: block 0's experts (bf16,
    dropless) on one token alone and as the last of N tokens, for each
    N of `sizes`.  {N: the row bitwise equal, its largest difference}."""
    from singa_tpu_torch.ops import moe
    w = {k: params[f"blocks.0.ffn.{k}"]
         for k in ("router", "w_in", "w_out", "w_gate")}
    dev = w["router"].device
    g = torch.Generator(dev).manual_seed(4)
    x = torch.randn(max(sizes), c.dim, generator=g, device=dev) \
        .to(torch.bfloat16)

    def ffn(xs):
        return moe.moe_forward(xs, w["router"], w["w_in"], w["w_out"],
                               c.moe_capacity_factor, top_k=c.moe_top_k,
                               w_gate=w["w_gate"])
    out = {}
    with torch.no_grad():
        one = ffn(x[:1])[0]
        for n in sizes:
            row = ffn(torch.cat([x[1:n], x[:1]]))[-1]
            out[n] = {"bitwise": torch.equal(row, one),
                      "max_abs_diff": (row.float() - one.float()).abs()
                      .max().item()}
    return out


def _chosen(probs, k):
    """(..., E) router probabilities -> (the k experts chosen, sorted;
    the margin p_k - p_(k+1) that a flip of the k-th choice must
    cross)."""
    v, i = probs.topk(k + 1, dim=-1)
    return i[..., :k].sort(-1).values, v[..., k - 1] - v[..., k]


def engine_routes(m, prompts, new):
    """The serve engine (the moe phase's shape, bf16) over `prompts`,
    every program dispatch run eagerly so that `route_trace` sees it:
    (streams, each request's (new, layers, E) router probabilities of
    the row that produced each token, the engine).  A decode tick's
    rows are the slots; a prefill chunk's token comes from its last
    valid row."""
    from singa_tpu_torch.serve import program

    def make(call):
        def eager(self):
            if self.calls == 0:
                return call(self)
            self.body()
            self.calls += 1
        return eager
    L, slots = m.cfg.num_layers, SERVE_SLOTS
    check(slots != SERVE_BLOCK, "a decode tick's rows and a prefill "
          "chunk's would not be told apart")
    routes = [[] for _ in prompts]
    with _swap(program.Program, "__call__", make):
        eng, _ = serve_engine(m, slots, SERVE_MAX_LEN, SERVE_BLOCK)
        chunk_last = [0]
        prefill_chunk = eng._prefill_chunk

        def chunked(ids, start, slot):
            chunk_last[0] = ids.size - 1
            return prefill_chunk(ids, start, slot)
        eng._prefill_chunk = chunked
        with route_trace() as calls:
            def on_token(i):
                def cb(tok, h):
                    last = calls[-L:]
                    row = (h._req.slot if last[0].shape[0] == slots
                           else chunk_last[0])
                    routes[i].append(torch.stack([c[row] for c in last]))
                return cb
            hs = [eng.submit(p, max_new_tokens=new, on_token=on_token(i))
                  for i, p in enumerate(prompts)]
            eng.run_until_idle()
    streams = [list(map(int, h.tokens)) for h in hs]
    return streams, [torch.stack(r).cpu() for r in routes], eng


def generate_routes(m, prompts, new):
    """Eager generate() (bf16, one call per prompt) under `route_trace`:
    (streams, each request's (new, layers, E) router probabilities of
    the row that produced each token: the prefill's last, then each
    decode step's one)."""
    L = m.cfg.num_layers
    streams, routes = [], []
    for p in prompts:
        with route_trace() as calls:
            out = m.generate(p[None], max_new_tokens=new, use_graph=False,
                             param_dtype=torch.bfloat16)
        rows = [torch.stack([c[p.size - 1 if j == 0 else 0]
                             for c in calls[j * L:(j + 1) * L]])
                for j in range(new)]
        streams.append(list(map(int, out[0, p.size:])))
        routes.append(torch.stack(rows).cpu())
    return streams, routes


def teacher_routes(m, eng, prompts, streams):
    """teacher_forced_gaps (the kernels' forward) under `route_trace`:
    (each request's gaps, its (new, layers, E) router probabilities of
    the row that scored each token)."""
    L = m.cfg.num_layers
    with route_trace() as calls:
        gaps, _ = teacher_forced_gaps(m, eng, prompts, streams, plain=False)
    routes, per, at = [], [], 0
    for i, (p, toks) in enumerate(zip(prompts, streams)):
        layer = calls[i * L:(i + 1) * L]
        routes.append(torch.stack(layer, 1)[p.size - 1:p.size - 1
                                            + len(toks)].cpu())
        per.append(gaps[at:at + len(toks)])
        at += len(toks)
    return per, routes


def routed_alike_gaps(routes, teacher, gaps, k, limit):
    """A path's teacher-forced gaps split by whether the row that
    produced each token chose the same k experts in every layer as the
    teacher-forced forward's row: the gate holds the alike positions to
    `limit`; the others' teacher margins show how near a flip was."""
    alike, g_alike, g_flip, m_flip, m_alike = [], [], [], [], []
    for r, t, g in zip(routes, teacher, gaps):
        (ri, _), (ti, tm) = _chosen(r, k), _chosen(t, k)
        same = (ri == ti).all(-1).all(-1).numpy()
        margin = tm.min(-1).values.numpy()
        alike.append(same)
        g_alike += list(g[same])
        g_flip += list(g[~same])
        m_flip += list(margin[~same])
        m_alike += list(margin[same])
    n = int(sum(a.size for a in alike))
    return {"limit": limit, "positions": n,
            "routed_alike": int(sum(a.sum() for a in alike)),
            "max_gap_alike": float(max(g_alike, default=0.0)),
            "alike_over_limit": int(sum(x > limit for x in g_alike)),
            "max_gap_flipped": float(max(g_flip, default=0.0)),
            "flipped_over_limit": int(sum(x > limit for x in g_flip)),
            "teacher_margin_flipped_max": float(max(m_flip, default=0.0)),
            "teacher_margin_alike_median": float(np.median(m_alike))
            if m_alike else None}


def divergence_routes(e_streams, e_routes, g_streams, g_routes, k):
    """For each request whose engine and generate() streams differ: the
    first differing token, the first token (at or before it) whose
    producing row chose other experts in the two paths, and at that
    token each path's router margin in the layer that flipped."""
    out = []
    for i, (es, gs) in enumerate(zip(e_streams, g_streams)):
        if es == gs:
            continue
        d = next(j for j, (a, b) in enumerate(zip(es, gs)) if a != b)
        (ei, em), (gi, gm) = (_chosen(e_routes[i][:d + 1], k),
                              _chosen(g_routes[i][:d + 1], k))
        differ = (ei != gi).any(-1)                       # (d + 1, L)
        rows = differ.any(-1).nonzero()
        entry = {"request": i, "first_differing_token": d,
                 "routing_differs_at_that_token": bool(differ[d].any())}
        if rows.numel():
            j = int(rows[0, 0])
            lay = int(differ[j].nonzero()[0, 0])
            entry.update({"first_routing_difference": j, "layer": lay,
                          "engine_experts": ei[j, lay].tolist(),
                          "generate_experts": gi[j, lay].tolist(),
                          "engine_margin": float(em[j, lay]),
                          "generate_margin": float(gm[j, lay])})
        out.append(entry)
    return out


def teacher_split(m, eng, prompt, common, a, b):
    """The kernels' forward over `prompt` and the `common` tokens under
    the engine's weights: at the next position, its logit of token `a`
    minus its logit of `b`."""
    from singa_tpu_torch.models import _generate
    seq = np.concatenate([prompt, np.asarray(common, prompt.dtype)])
    ids = torch.as_tensor(np.pad(seq, (0, -seq.size % 128))[None],
                          dtype=torch.int64, device=eng._device)
    with torch.no_grad(), _generate._bound(m, eng._params):
        lg = m(ids)[0, seq.size - 1].float()
    return float(lg[a] - lg[b])


def moe_route_check(m, prompts, new, captured, gen, later):
    """Why the bf16 MoE engine's streams leave generate()'s, and a bf16
    gate on the engine that routing flips cannot trip.  The engine and
    generate() rerun eagerly under `route_trace` (their streams held
    bitwise to the captured runs'), and the teacher-forced forward over
    each path's streams with it: at each token, whether the producing
    row chose the same experts in the path and in the forward.  Where
    it did, the engine's gap is held to SERVE_BF16_GAP.  Beside it, the
    row probe at every size the paths run an MoE layer on, and, where
    the two paths' streams part, the first routing difference, the
    router margins there, and the forward's logit split between the two
    paths' tokens."""
    k = m.cfg.moe_top_k
    e_streams, e_routes, eng = engine_routes(m, prompts, new)
    e_gaps, te_routes = teacher_routes(m, eng, prompts, e_streams)
    g_streams, g_routes = generate_routes(m, prompts, new)
    g_gaps, tg_routes = teacher_routes(m, eng, prompts, g_streams)
    pad = [(p.size + new - 1) + (-(p.size + new - 1) % 128)
           for p in prompts]
    sizes = sorted({1, SERVE_SLOTS, SERVE_BLOCK, MOE_GEN[0] * MOE_GEN[1],
                    *(p.size for p in prompts), *pad})
    probe = moe_row_probe(m.cfg, eng._params, sizes)
    divergence = divergence_routes(e_streams, e_routes, g_streams,
                                   g_routes, k)
    for d in divergence:
        i, j = d["request"], d["first_differing_token"]
        d["teacher_logit_engine_minus_generate"] = teacher_split(
            m, eng, prompts[i], e_streams[i][:j], e_streams[i][j],
            g_streams[i][j])
    eng.close()
    del eng
    m._gen_sessions.clear()
    res = {
        "eager_engine_equals_captured": e_streams == captured,
        "eager_generate_equals_captured": g_streams == gen,
        "engine": routed_alike_gaps(e_routes, te_routes, e_gaps, k,
                                    SERVE_BF16_GAP),
        "generate": routed_alike_gaps(g_routes, tg_routes, g_gaps, k,
                                      SERVE_BF16_GAP),
        "divergence": divergence,
        "row_probe": {"sizes": sizes,
                      "bitwise_at_every_size": all(
                          v["bitwise"] for v in probe.values()),
                      "differing": {n: v for n, v in probe.items()
                                    if not v["bitwise"]}}}
    later(res["eager_engine_equals_captured"]
          and res["eager_generate_equals_captured"],
          "an eager rerun's streams differ from the captured run's")
    eg = res["engine"]
    later(eg["routed_alike"] > 0 and eg["alike_over_limit"] == 0,
          f"bf16 engine tokens fail the teacher-forced check where "
          f"routing agreed: {eg}")
    return res


def config_serve(m, slots, max_len, block, prompts, new, later,
                 gate=True):
    """The paged engine (bf16 weights) over `prompts` x `new` tokens, all
    submitted at once: tokens/s, TTFT, tick and chunk ms, program
    counts, flash launches counted on the card from the engine's warm-up
    on; the streams against generate()'s (bf16, one call per prompt) and
    both sets' teacher-forced gaps (the kernels' forward), the engine's
    held to the serve phase's bf16 limit when `gate`.  Checks go to
    `later(cond, msg)`, as in the other config_* helpers, so a phase
    prints its results before any check stops the run.  Returns (result,
    engine, its streams, generate()'s) with the engine open."""
    from singa_tpu_torch.ops import flash_attention as fa

    fa.reset_device_launches()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng, _ = serve_engine(m, slots, max_len=max_len, block_size=block)
    counts_warm = eng.compiled_counts()
    streams, secs, _ = traffic(eng, prompts, new_tokens=new)
    snap = eng.metrics.snapshot()
    peak = torch.cuda.max_memory_allocated() - base
    tick_ms = _median_ms(eng._decode, n=21)
    chunk_ms = _median_ms(eng._prefill, n=21)
    counts = eng.compiled_counts()
    launches = fa.device_launches()
    kw = dict(max_new_tokens=new, param_dtype=torch.bfloat16)
    gen = [list(map(int, m.generate(p[None], **kw)[0, p.size:]))
           for p in prompts]
    m._gen_sessions.clear()
    gaps, agree = teacher_forced_gaps(m, eng, prompts, streams, plain=False)
    ggaps, gagree = teacher_forced_gaps(m, eng, prompts, gen, plain=False)
    n_tok = sum(len(t) for t in streams)
    ttft = snap["ttft_ms"]
    zero = dict.fromkeys(fa.KERNELS, 0)
    res = {"num_slots": slots, "max_len": max_len, "block_size": block,
           "param_dtype": "bfloat16", "requests": len(prompts),
           "max_new_tokens": new,
           "prompt_lens": [int(p.size) for p in prompts],
           "compiled_counts": {"after_warm_up": counts_warm,
                               "after_traffic": counts},
           "captured": eng._decode.graph.graph is not None,
           "seconds": secs, "tokens": n_tok, "tokens_per_s": n_tok / secs,
           "ttft_ms": {"p50": ttft["p50"], "p99": ttft["p99"],
                       "max": ttft["max"]},
           "decode_tick_ms": tick_ms, "prefill_chunk_ms": chunk_ms,
           "prefix_hits": snap["prefix_hits"], "steps": snap["steps"],
           "peak_memory_bytes": peak, "flash_launches": launches,
           "vs_generate": {**_differ(streams, gen),
                           "token_agreement": float(np.mean(
                               [np.mean(np.asarray(a) == np.asarray(b))
                                for a, b in zip(streams, gen)]))},
           "teacher_forced_bf16": {
               "limit": SERVE_BF16_GAP,
               "engine": _gap_summary(gaps, agree, SERVE_BF16_GAP),
               "generate": _gap_summary(ggaps, gagree, SERVE_BF16_GAP)}}
    later(counts == (1, 1) and res["captured"],
          f"compiled_counts {counts}, expected (1, 1), captured")
    later(all(len(t) == new for t in streams)
          and all(0 <= x < m.cfg.vocab_size for t in streams for x in t),
          "the engine's streams are short or out of range")
    later(launches == zero, f"the flash kernels ran {launches} times on "
          f"the serve path")
    later(not gate or float(gaps.max()) <= SERVE_BF16_GAP,
          f"engine tokens fail the teacher-forced check: max gap "
          f"{gaps.max()}")
    return res, eng, streams, gen


def oracle_f32_masters(m, prompts):
    """The serve phase's f32 oracle on `m` itself: an engine over its f32
    masters computing in f32 (arena and activations) serves `prompts`;
    its tokens' teacher-forced gaps, and its streams beside f32
    generate()'s.  In bf16 an MoE's routing flips between two experts
    whose router scores lie within a rounding of each other, and a
    flipped token's gap exceeds the bf16 gate (moe_route_check)."""
    dev = m.device
    saved, dev.default_dtype = dev.default_dtype, torch.float32
    try:
        eng, _ = serve_engine(m, param_dtype=None)
        streams, _ = serve_traffic(eng, prompts)
        gaps, agree = teacher_forced_gaps(m, eng, prompts, streams)
        eng.close()
        gen = [list(map(int, m.generate(p[None], max_new_tokens=SERVE_NEW)
                        [0, p.size:])) for p in prompts]
    finally:
        dev.default_dtype = saved
        m._gen_sessions.clear()
    return gaps, {"delta": SERVE_DELTA, "requests": len(prompts),
                  "sound": _gap_summary(gaps, agree, SERVE_DELTA),
                  "vs_generate_f32": _differ(streams, gen)}


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def phase_banded():
    """mistral-w4096 (Mistral-7B-v0.1's widths, cut to BANDED_LAYERS
    layers): training at T = 8192 with all three kernels banded,
    generate() with a banded prefill, and the paged engine over prompts
    longer than the window."""
    from singa_tpu_torch.models.llama import PUBLISHED

    t0 = time.perf_counter()
    cfg = dataclasses.replace(PUBLISHED["mistral-w4096"],
                              num_layers=BANDED_LAYERS, fused_loss=True)
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    m = config_model(cfg)
    params = m.num_params()
    train = config_train(m, *BANDED_TRAIN, later, cfg.num_layers,
                         m.flops_per_token(BANDED_TRAIN[1]))
    del m
    _free()
    m = config_model(cfg)
    gen = config_generate(m, *BANDED_GEN, later)
    rng = np.random.RandomState(BANDED_SEED)
    slots, max_len, block, n_req, new = BANDED_SERVE
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(BANDED_PROMPTS[0], BANDED_PROMPTS[1] + 1,
                                    n_req)]
    serve, eng, _, _ = config_serve(m, slots, max_len, block, prompts, new,
                                    later)
    eng.close()
    del eng, m
    _free()
    emit({"phase": "banded", "config": "mistral-w4096",
          "source": "Mistral-7B-v0.1 config.json, 32 -> "
                    f"{BANDED_LAYERS} layers", "params": params,
          "sliding_window": cfg.sliding_window, "train": train,
          "generate": gen, "serve": serve,
          "phase_seconds": time.perf_counter() - t0})
    later(min(len(p) for p in prompts) > cfg.sliding_window,
          "a serve prompt fits the window")
    for cond, msg in checks:
        check(cond, msg)
    return {"train": train, "generate": gen, "serve": serve}


def phase_moe():
    """mixtral-8x7b (Mixtral-8x7B-v0.1's widths, cut to MOE_LAYERS
    layers, dropless capacity factor E/k): training with the aux loss,
    generate(), the paged engine over the serve phase's prompts, and the
    load generator through that engine."""
    from singa_tpu_torch.models.llama import PUBLISHED

    t0 = time.perf_counter()
    cfg = dataclasses.replace(PUBLISHED["mixtral-8x7b"],
                              num_layers=MOE_LAYERS, fused_loss=True)
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    m = config_model(cfg)
    params = m.num_params()
    train = config_train(m, *MOE_TRAIN, later, cfg.num_layers,
                         m.flops_per_token(MOE_TRAIN[1]))
    b, t = MOE_TRAIN
    n_tok = b * t
    cap = math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * n_tok
                    / cfg.num_experts)
    train["expert_rows_over_active"] = (cfg.num_experts * cap
                                        / (cfg.moe_top_k * n_tok))
    del m
    _free()
    m = config_model(cfg)
    gen = config_generate(m, *MOE_GEN, later)
    prompts = serve_prompts(cfg.vocab_size)
    # the engine is gated where routing agreed (moe_route_check)
    serve, eng, streams, gen_streams = config_serve(
        m, SERVE_SLOTS, SERVE_MAX_LEN, SERVE_BLOCK, prompts, SERVE_NEW,
        later, gate=False)
    load = load_run(eng, serve["tokens_per_s"], SERVE_NEW, "mixtral-8x7b")
    eng.close()
    del eng
    _free()
    serve["routing"] = moe_route_check(m, prompts, SERVE_NEW, streams,
                                       gen_streams, later)
    _free()
    gaps, serve["teacher_forced_f32"] = oracle_f32_masters(
        m, prompts[:SERVE_ORACLE])
    later(float(gaps.max()) <= SERVE_DELTA, f"f32 engine tokens fail the "
          f"teacher-forced oracle: max gap {gaps.max()} > {SERVE_DELTA}")
    del m
    _free()
    emit({"phase": "moe", "config": "mixtral-8x7b",
          "source": "Mixtral-8x7B-v0.1 config.json, 32 -> "
                    f"{MOE_LAYERS} layers", "params": params,
          "num_experts": cfg.num_experts, "top_k": cfg.moe_top_k,
          "capacity_factor": cfg.moe_capacity_factor, "train": train,
          "generate": gen, "serve": serve,
          "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return {"train": train, "generate": gen, "serve": serve,
            "load": load["flash_launches"]}


def _host_states(m):
    return {n: t.detach().cpu().clone() for n, t in m.get_states().items()}


def _images(shape, classes, b=CNN_B, seed=CNN_SEED):
    """A batch of random images (b, *shape) and labels on the card."""
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((b, *shape), generator=gen, device="cuda")
    y = torch.randint(0, classes, (b,), generator=gen, device="cuda")
    return x, y.to(torch.int32)


def _step_grads(m, x, y):
    """One training-mode forward's logits and loss and every parameter's
    gradient, on the host, without an update."""
    from singa_tpu_torch import autograd
    with autograd.train_mode():
        logits = m.forward(x).float()
        loss = autograd.softmax_cross_entropy(logits, y)
        grads = {p.param_name: g.cpu() for p, g in autograd.backward(loss)}
    for p in m.get_params().values():
        p.grad = None
    return logits.detach().cpu(), loss.item(), grads


@contextmanager
def flipped_conv_weights():
    """A planted fault: every convolution reads its HWIO weight flipped
    in H and W (a correlation computed as a convolution)."""
    from singa_tpu_torch import autograd
    conv = autograd.conv2d
    autograd.conv2d = lambda x, w, *a, **k: conv(x, w.flip(0, 1), *a, **k)
    try:
        yield
    finally:
        autograd.conv2d = conv


def cnn_f32_vs_cpu(m, factory, x, y, start):
    """The card's f32 step (TF32 off) at CNN_CHECK_B against the port on
    the CPU with the same weights, and the same comparison with the
    convolutions' weights flipped on the card, which must fail it; `m`'s
    states are restored after."""
    from singa_tpu_torch import device
    xb, yb = x[:CNN_CHECK_B], y[:CNN_CHECK_B]
    cpu_m = factory(device=device.create_device("cpu"))
    cpu_m.set_states(start)
    card = _step_grads(m, xb, yb)
    m.set_states(start)
    ulp = _step_grads(m, xb * (1 + 2 ** -23), yb)
    m.set_states(start)
    with flipped_conv_weights():
        fault = _step_grads(m, xb, yb)
    host = _step_grads(cpu_m, xb.cpu(), yb.cpu())
    m.set_states(start)
    del cpu_m

    def grad_diffs(a, b):
        return sorted(((a[2][n] - g).norm() / g.norm()).item()
                      for n, g in b[2].items())
    logit = ((card[0] - host[0]).abs().max() / host[0].abs().max()).item()
    loss = abs(card[1] - host[1]) / abs(host[1])
    grads, spread = grad_diffs(card, host), grad_diffs(ulp, card)
    planted = grad_diffs(fault, host)
    return {"B": CNN_CHECK_B, "dtype": "float32", "tf32": False,
            "logit_err_over_max": logit, "loss_card": card[1],
            "loss_cpu": host[1], "loss_rel_diff": loss,
            "grad_rel_diff_max": grads[-1],
            "grad_rel_diff_median": grads[len(grads) // 2],
            "card_one_ulp_input_grad_rel_diff_max": spread[-1],
            "card_one_ulp_input_grad_rel_diff_median":
                spread[len(spread) // 2],
            "planted_fault": {
                "what": "every conv weight flipped in H and W on the card",
                "grad_rel_diff_max": planted[-1],
                "grad_rel_diff_median": planted[len(planted) // 2],
                "grad_rel_diff_min": planted[0],
                "loss_rel_diff": abs(fault[1] - host[1]) / abs(host[1]),
                "fails_the_gate": planted[-1] > CNN_F32_GRAD},
            "limits": {"logit": CNN_F32_LOGIT, "loss": CNN_F32_LOSS,
                       "grad": CNN_F32_GRAD},
            "ok": logit <= CNN_F32_LOGIT and loss <= CNN_F32_LOSS
            and grads[-1] <= CNN_F32_GRAD and planted[-1] > CNN_F32_GRAD}


def cnn_eval_check(m, x):
    """Captured eval forwards (eager-recorded, warm-up, capture + replay,
    replay) against an eager eval forward, bitwise."""
    m.compile([x], is_train=False, use_graph=True)
    outs = [m(x) for _ in range(4)]
    g = m.get_graph("eval")
    captured, pool = g.graph is not None, g.pool_bytes
    del g
    m.compile([x], is_train=False, use_graph=False)
    eager = m(x)
    return {"captured": captured, "pool_bytes": pool,
            "bitwise": all(torch.equal(o, eager) for o in outs),
            "finite": bool(torch.isfinite(eager).all())}


def activation_copies(fn, numel):
    """Ops of one call of fn that copy at least `numel` elements, as the
    profiler records the aten ops (nested ones included): layout copies
    (aten::clone, which .contiguous() calls) and dtype casts
    (aten::_to_copy)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
        torch.cuda.synchronize()
    counts = {"aten::clone": 0, "aten::_to_copy": 0}
    for e in p.events():
        if e.name in counts and e.input_shapes and e.input_shapes[0] \
                and math.prod(e.input_shapes[0]) >= numel:
            counts[e.name] += 1
    return {"min_numel": numel, "layout_copies": counts["aten::clone"],
            "casts": counts["aten::_to_copy"]}


def saved_bytes(m, x):
    """Bytes of the tensors autograd saves for the backward of one
    training-mode forward of `x` (each storage once); `m`'s running
    statistics move, so the caller restores them.  The saved tensors are
    held here, not in the graph: a node saving its own output would
    otherwise hold itself alive, with the parameters' gradient
    accumulators made on this stream, which a later capture on its own
    stream cannot use."""
    from singa_tpu_torch import autograd
    kept = []

    def pack(t):
        kept.append(t)
        return len(kept) - 1

    def unpack(_):
        raise RuntimeError("saved_bytes runs no backward")
    with torch.autograd.graph.saved_tensors_hooks(pack, unpack), \
            autograd.train_mode():
        m.forward(x.to(m.device.default_dtype))
    sizes = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
             for t in kept}
    kept.clear()
    return sum(sizes.values())


def cnn_train(name, factory, shape, classes, later, full=False,
              make_opt=None):
    """`factory`'s model trained at CNN_B through set_optimizer, compile
    and train_step: CNN_BITWISE steps eager (a second model from the
    same seed) and captured under deterministic cuDNN, held bitwise and
    then timed as replays; then, as the path runs, CNN_EAGER eager
    steps and a fresh capture with CNN_STEPS timed replays.  `full` adds
    the f32 check against the CPU, the eval check, a profile of one
    replay and the activation copies of an eager step.  `make_opt`
    makes the optimizer (default SGD with CNN_SGD)."""
    from singa_tpu_torch import device, opt
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.utils.flops import model_forward_flops
    from singa_tpu_torch.utils.metrics import peak_flops

    make_opt = make_opt or (lambda: opt.SGD(**CNN_SGD))
    dev = device.create_device("cuda")

    def build():
        gen = torch.Generator("cuda").manual_seed(CNN_SEED)
        return factory(device=dev, generator=gen)
    m = build()
    start = _host_states(m)
    x, y = _images(shape, classes)
    res = {"model": name, "B": CNN_B, "input_hwc": list(shape),
           "classes": classes, "optimizer": _opt_name(make_opt()),
           "params": sum(p.numel() for p in m.get_params().values())}
    if full:
        one, two = saved_bytes(m, x[:1]), saved_bytes(m, x[:2])
        res["saved_for_backward"] = {"bytes_per_image": two - one,
                                     "bytes_fixed": 2 * one - two}
        res["f32_vs_cpu"] = cnn_f32_vs_cpu(m, factory, x, y, start)
        later(res["f32_vs_cpu"]["ok"], f"{name}: the card's f32 step differs "
              f"from the CPU's: {res['f32_vs_cpu']}")

    torch.backends.cudnn.deterministic = True
    try:
        e = build()
        later(all(torch.equal(t.cpu(), start[n])
                  for n, t in e.get_states().items()),
              f"{name}: two models from one seed differ")
        e.set_optimizer(make_opt())
        e.compile([x], is_train=True, use_graph=False)
        eager = [e.train_step(x, y)[1].item() for _ in range(CNN_BITWISE)]
        eager_states = _host_states(e)
        del e
        _free()
        m.set_optimizer(make_opt())
        m.compile([x], is_train=True, use_graph=True)
        cap = [m.train_step(x, y)[1].item() for _ in range(CNN_BITWISE)]
        differ = [n for n, t in _host_states(m).items()
                  if not torch.equal(t, eager_states[n])]
        det = [_timed(lambda: m.train_step(x, y))[1]
               for _ in range(CNN_STEPS)]
        res["captured_vs_eager"] = {
            "cudnn_deterministic": True, "steps": CNN_BITWISE,
            "eager_losses": eager, "captured_losses": cap,
            "bitwise_losses": eager == cap, "states_differing": differ,
            "states": len(eager_states),
            "replay_median_step_ms": sorted(det)[len(det) // 2] * 1e3}
        later(eager == cap and not differ, f"{name}: captured steps are not "
              f"the eager ones bitwise: {res['captured_vs_eager']}")
        if full:
            res["eval_captured_vs_eager"] = ev = cnn_eval_check(m, x)
            later(ev["captured"] and ev["bitwise"] and ev["finite"],
                  f"{name}: the captured eval differs from eager: {ev}")
    finally:
        torch.backends.cudnn.deterministic = False
    del eager_states
    _free()

    # as the path runs: eager steps, then a fresh capture and its replays
    m.set_states(start)
    m.set_optimizer(make_opt())
    m.compile([x], is_train=True, use_graph=False)
    eager_s = [_timed(lambda: m.train_step(x, y))[1] for _ in range(CNN_EAGER)]
    m.compile([x], is_train=True, use_graph=True)
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first = [_timed(lambda: m.train_step(x, y)) for _ in range(3)]
    losses = [out[1].item() for out, _ in first]
    times = []
    for _ in range(CNN_STEPS):
        (_, loss), t = _timed(lambda: m.train_step(x, y))
        losses.append(loss.item())
        times.append(t)
    peak = torch.cuda.max_memory_allocated()
    g = m.get_graph("train")
    flops_img = model_forward_flops(m, x[:1].to(dev.default_dtype))
    step_s = sorted(times)[len(times) // 2]
    eager_step = sorted(eager_s)[len(eager_s) // 2]
    step_flops = 3 * flops_img * CNN_B
    rate = peak_flops()
    res.update({
        "captured": g.graph is not None, "capture_s": g.capture_seconds,
        "graph_num_ops": g.num_ops, "graph_flops": g.flops(),
        "graph_pool_bytes": g.pool_bytes, "graph_launches": g.launches,
        "first_calls_ms": [t * 1e3 for _, t in first],
        "step_ms": [t * 1e3 for t in times], "median_step_ms": step_s * 1e3,
        "images_per_s": CNN_B / step_s,
        "forward_flops_per_image": flops_img,
        "flops_per_step": step_flops,
        "mfu": step_flops / step_s / rate, "peak_flops": rate,
        "eager": {"step_ms": [t * 1e3 for t in eager_s],
                  "median_step_ms": eager_step * 1e3,
                  "images_per_s": CNN_B / eager_step,
                  "mfu": step_flops / eager_step / rate},
        "peak_memory_bytes": peak, "allocated_before_bytes": live,
        "reserved_bytes": torch.cuda.memory_reserved(),
        "losses": losses})
    del g
    later(res["captured"], f"{name}: train_step did not capture")
    later(np.isfinite(losses).all(), f"{name}: non-finite loss {losses}")
    if full:
        res["flash_launches_before_profile"] = fa.device_launches()
        res["profile"] = phase_profile(
            lambda: m.train_step(x, y),
            f"one replayed {name} train step, B={CNN_B}",
            dict.fromkeys(fa.KERNELS, 0))
        m.compile([x], is_train=True, use_graph=False)
        _free()
        res["copies_in_an_eager_step"] = cp = activation_copies(
            lambda: m.train_step(x, y), CNN_B * 7 * 7 * 512)
        later(cp["layout_copies"] == 0, f"{name}: an eager step copies "
              f"activations into another layout: {cp}")
    del m
    return res


def cnn_cli(later):
    """tools/train_cnn.py on the card: one epoch of each CNN_CLI pair."""
    from singa_tpu_torch.tools import train_cnn
    runs = {}
    for model, data in CNN_CLI:
        t0 = time.perf_counter()
        out = train_cnn.main(["--model", model, "--dataset", data,
                              "--epochs", "1", "--lr", "0.01",
                              "--log-every", "0"])
        ep = out["epochs"][0]
        runs[f"{model}/{data}"] = {
            "batch_size": out["batch_size"], "steps": out["steps_per_epoch"],
            "first_loss": ep["losses"][0], "last_loss": ep["losses"][-1],
            "train_loss": ep["train_loss"], "train_acc": ep["train_acc"],
            "test_acc": ep["test_acc"], "images_per_s": ep["images_per_s"],
            "eval_captured": out["eval_captured"], "device": out["device"],
            "seconds": time.perf_counter() - t0}
        later(np.isfinite(ep["losses"]).all(),
              f"train_cnn {model}: non-finite loss {ep['losses']}")
        later(out["eval_captured"] and out["device"].startswith("cuda"),
              f"train_cnn {model}: the eval did not run captured on the "
              f"card: {runs[f'{model}/{data}']}")
        _free()
    return runs


def phase_cnn():
    """The vision path: ImageNet ResNet-50 and CIFAR ResNet-18 training
    through compile/train_step as CUDA graphs, and the train_cnn CLI; no
    flash kernel runs."""
    from singa_tpu_torch import models
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    fa.reset_device_launches()
    r50 = cnn_train("resnet50", models.resnet50, (224, 224, 3), 1000, later,
                    full=True)
    _free()
    r18 = cnn_train("resnet18_cifar", models.resnet18, (32, 32, 3), 10, later)
    _free()
    cli = cnn_cli(later)
    before = r50.pop("flash_launches_before_profile")
    after = fa.device_launches()
    launches = {k: before[k] + after[k] for k in fa.KERNELS}
    r50["published_forward_flops_per_image"] = RESNET50_GFLOP * 1e9
    SUMMARY["cnn"] = {k: r50[k] for k in ("optimizer", "median_step_ms",
                                          "images_per_s", "mfu",
                                          "peak_memory_bytes")}
    emit({"phase": "cnn", "resnet50": r50, "resnet18_cifar": r18,
          "cli": cli, "flash_launches": launches,
          "phase_seconds": time.perf_counter() - t0})
    later(abs(r50["forward_flops_per_image"] / 1e9 - RESNET50_GFLOP)
          <= 0.02 * RESNET50_GFLOP, "ResNet-50's counted forward FLOPs are "
          "not the published count")
    later(not any(launches.values()), f"flash kernels ran on the CNN path: "
          f"{launches}")
    for cond, msg in checks:
        check(cond, msg)
    return launches


# phase native: the native core (singa_tpu_torch._core, built by g++ from
# singa_tpu_torch/csrc/core) on the card's host.  The threaded loader
# (kernel_check.NATIVE_WORKERS workers, a ring of NATIVE_PREFETCH)
# feeds phase cnn's ResNet-50 cell through prefetch_to_device, the loss
# read every step, beside the numpy pipeline and the replay alone
# (NATIVE_REPLAYS steps on a batch already on the card); NATIVE_IMAGES
# images at 224² (three batches of CNN_B an epoch), labels arange(n).
# With three batches an epoch, prefetch_to_device pulls the whole epoch
# at its first step, so a pipeline's cost shows in the epoch-first
# steps and in the window's wall time, not in the later steps
NATIVE_IMAGES, NATIVE_REPLAYS = 768, 6


def native_asan():
    """The core's test binary under ASan and UBSan, built and run; not
    run where g++ here cannot link the sanitizers.  A build that raises
    or a binary that runs past its limit is a failed run."""
    from singa_tpu_torch import _build
    t0 = time.perf_counter()
    try:
        if not _build.asan_supported():
            return {"run": False, "why": "g++ here links no -fsanitize="
                    "address,undefined program", "passed": None}
        exe = _build.build_asan()
        r = subprocess.run([str(exe)], capture_output=True, text=True,
                           timeout=300)
    except Exception as e:          # noqa: BLE001 -- reported as a failure
        return {"run": True, "passed": False, "error": repr(e)[-2000:],
                "seconds": time.perf_counter() - t0}
    return {"run": True, "rc": r.returncode,
            "passed": r.returncode == 0
            and "ALL NATIVE TESTS PASSED" in r.stdout,
            "output_tail": (r.stdout + r.stderr)[-400:],
            "seconds": time.perf_counter() - t0}


def native_models(later):
    """Phase cnn's two cells built again from CNN_SEED: ResNet-50 (the
    loader's, compiled later) and CIFAR ResNet-18, captured at CNN_B
    with CNN_SGD (schedule()'s)."""
    from singa_tpu_torch import device, models, opt
    dev = device.create_device("cuda")

    def build(factory):
        gen = torch.Generator("cuda").manual_seed(CNN_SEED)
        return factory(device=dev, generator=gen)
    r18 = build(models.resnet18)
    x, y = _images((32, 32, 3), 10)
    r18.set_optimizer(opt.SGD(**CNN_SGD))
    r18.compile([x], is_train=True, use_graph=True)
    for _ in range(3):
        r18.train_step(x, y)
    torch.cuda.synchronize()
    later(r18.get_graph("train").graph is not None,
          "ResNet-18's train step did not capture")
    return build(models.resnet50), r18


def native_loader_cell(m, x_np, labels, later):
    """Phase cnn's ResNet-50 cell (B = CNN_B, 224², SGD CNN_SGD) fed by
    the native loader and by the numpy pipeline in turns (native, numpy,
    numpy, native; two epochs each), beside the replay alone; every
    batch held whole (kernel_check.native_feed).  Each pipeline's
    images/s is over its whole window (every step's wall time, batch
    waits included)."""
    from singa_tpu_torch import kernel_check, opt
    from singa_tpu_torch.utils.data import DataLoader
    x_dev = torch.from_numpy(x_np).cuda()
    x0, y0 = x_dev[:CNN_B], torch.from_numpy(labels[:CNN_B]).cuda()
    m.set_optimizer(opt.SGD(**CNN_SGD))
    m.compile([x0], is_train=True, use_graph=True)
    warm = [_timed(lambda: m.train_step(x0, y0))[1] for _ in range(3)]

    def step(xb, yb):
        return m.train_step(xb, yb)[1].item()

    replay = []
    for _ in range(NATIVE_REPLAYS):
        t0 = time.perf_counter()
        step(x0, y0)
        torch.cuda.synchronize()
        replay.append(time.perf_counter() - t0)
    rmed = sorted(replay)[len(replay) // 2]
    runs = {"native": [], "numpy": []}
    for name in ("native", "numpy", "numpy", "native"):
        loader = DataLoader(x_np, labels, batch_size=CNN_B, seed=CNN_SEED,
                            workers=kernel_check.NATIVE_WORKERS,
                            prefetch=kernel_check.NATIVE_PREFETCH,
                            use_native=name == "native")
        r = kernel_check.native_feed(step, loader, x_dev)
        loader.close()
        runs[name].append(r)
        whole = {k: r[k] for k in ("rows_match_labels",
                                    "each_label_once_per_epoch", "epochs")}
        later(r["rows_match_labels"] and r["each_label_once_per_epoch"],
              f"the {name} loader's batches are not whole: {whole}")
        later(np.isfinite(r["losses"]).all(), f"{name}: non-finite loss")
    per_epoch = len(labels) // CNN_B
    out = {"model": "resnet50", "B": CNN_B, "images": NATIVE_IMAGES,
           "batch_bytes": CNN_B * 224 * 224 * 3 * 4,
           "batches_an_epoch": per_epoch,
           "workers": kernel_check.NATIVE_WORKERS,
           "prefetch": kernel_check.NATIVE_PREFETCH,
           "epochs_a_round": kernel_check.NATIVE_EPOCHS,
           "order": "native, numpy, numpy, native",
           "capture_first_calls_ms": [t * 1e3 for t in warm],
           "replay_only": {"step_ms": [t * 1e3 for t in replay],
                           "median_step_ms": rmed * 1e3,
                           "images_per_s": CNN_B / rmed}}
    for name, rounds in runs.items():
        walls = [t for r in rounds for t in r["step_s"]]
        first = walls[::per_epoch]
        rest = sorted(t for i, t in enumerate(walls) if i % per_epoch)
        window = sum(walls)
        out[name] = {
            "step_ms": [[t * 1e3 for t in r["step_s"]] for r in rounds],
            "batch_wait_ms": [[t * 1e3 for t in r["wait_s"]]
                              for r in rounds],
            "epoch_first_step_ms": [t * 1e3 for t in first],
            "later_steps_median_ms": rest[len(rest) // 2] * 1e3,
            "mean_step_ms": window / len(walls) * 1e3,
            "window_s": window, "steps": len(walls),
            "images_per_s": CNN_B * len(walls) / window,
            "mean_over_replay": window / len(walls) / rmed,
            "losses": [r["losses"] for r in rounds],
            "batches_whole": all(r["rows_match_labels"]
                                 and r["each_label_once_per_epoch"]
                                 for r in rounds)}
    del x_dev, x0, y0
    return out


def native_schedule(m, later):
    """schedule() of phase cnn's CIFAR ResNet-18 step, captured: traced
    on demand over fake tensors, its order checked against the traced
    graph's dependencies, its arena beside the capture's pool."""
    from singa_tpu_torch import kernel_check
    g = m.get_graph("train")
    t0 = time.perf_counter()
    s = g.schedule()
    secs = time.perf_counter() - t0
    topo = kernel_check.schedule_is_topological(s)
    later(topo and s.num_nodes > 100 and s.arena_bytes > 0,
          f"ResNet-18's schedule is not a topological order of its "
          f"{s.num_nodes} nodes (arena {s.arena_bytes} B)")
    return {"model": "resnet18_cifar", "B": CNN_B, "num_nodes": s.num_nodes,
            "order_is_topological": topo, "arena_bytes": s.arena_bytes,
            "graph_pool_bytes": g.pool_bytes,
            "arena_over_pool": s.arena_bytes / g.pool_bytes,
            "trace_and_plan_s": secs}


def phase_native():
    """The native core on the card's host: the library built from the
    checkout (timed alone), then its test binary under ASan on a thread
    beside the untimed set-up (the host kernels' MLP steps against
    torch's, the two models, the image set), joined before schedule()
    of a card step and the threaded loader feeding ResNet-50's captured
    step are timed."""
    import threading
    from singa_tpu_torch import _build, _core, kernel_check
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    built = _core.built()
    emit({"phase": "native", "build": {
        "library": built.path.name, "gxx_seconds": built.seconds,
        "version": _core.version(), "flags": _build.GXX_FLAGS}})
    asan = {}
    th = threading.Thread(target=lambda: asan.update(native_asan()))
    th.start()
    try:
        fa.reset_device_launches()
        native, calls = kernel_check.native_mlp_losses(True)
        plain, plain_calls = kernel_check.native_mlp_losses(False)
        mlp = {"native_losses": native, "plain_losses": plain,
               "native_calls": calls, "plain_calls": plain_calls,
               "rtol": kernel_check.NATIVE_MLP_RTOL,
               "atol": kernel_check.NATIVE_MLP_ATOL,
               "torch_threads": torch.get_num_threads(),
               "core_omp_threads": _core.omp_max_threads(),
               "ok": calls > 0 and plain_calls == 0 and bool(np.allclose(
                   native, plain, rtol=kernel_check.NATIVE_MLP_RTOL,
                   atol=kernel_check.NATIVE_MLP_ATOL))}
        later(mlp["ok"], f"the host kernels' MLP steps differ from "
              f"torch's or did not run: {mlp}")
        r50, r18 = native_models(later)
        x_np, labels = kernel_check.native_set(NATIVE_IMAGES, (224, 224, 3),
                                               seed=CNN_SEED)
    finally:
        th.join()
    later(asan.get("run") is False or asan.get("passed") is True,
          f"the core's ASan test binary did not pass: {asan}")
    sched = native_schedule(r18, later)
    del r18
    _free()
    loader = native_loader_cell(r50, x_np, labels, later)
    del r50, x_np
    _free()
    launches = fa.device_launches()
    later(not any(launches.values()), f"flash kernels ran in phase "
          f"native: {launches}")
    emit({"phase": "native", "nvidia_smi": smi_line(), "asan": asan,
          "loader": loader, "mlp_host_kernels": mlp, "schedule": sched,
          "flash_launches": launches,
          "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)


def gpt2_model(cfg):
    """GPT-2 at `cfg` on the card, f32 masters from seed 0."""
    from singa_tpu_torch import device
    from singa_tpu_torch.models import GPT2
    return GPT2(cfg, device=device.create_device("cuda"),
                generator=torch.Generator("cuda").manual_seed(0))


def _gpt2_loss(m, x):
    """GPT-2's training loss: the fused loss against the tied head."""
    from singa_tpu_torch.models.transformer import next_token_loss_fused_w
    h = m.features(x)
    return next_token_loss_fused_w(h, m._tied_head_w(h), x)


def gpt2_kernel_vs_plain(m, ids):
    """One GPT-2 step's loss and gradients with the kernels against the
    same step with their plain versions, eagerly, the dropout masks
    drawn alike (the generator reseeded before each)."""
    from singa_tpu_torch.model import _dropout_generators
    gens = _dropout_generators(m)

    def run():
        for g in gens:
            g.manual_seed(1)
        return _loss_and_grads(m, ids, GPT2_GRAD_NAMES, _gpt2_loss)
    with plain_attention():
        loss_p, g_p = run()
    return {**_step_errors(*run(), loss_p, g_p), "loss_plain": loss_p,
            "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL}


def _bert_batch(rng, vocab, b, t):
    """One BERT classification batch on the card: ids (b, t), labels
    (b,) of two classes."""
    return (torch.as_tensor(rng.randint(0, vocab, (b, t)).astype(np.int32),
                            device="cuda"),
            torch.as_tensor(rng.randint(0, 2, b).astype(np.int32),
                            device="cuda"))


def bert_eval(m, later):
    """BERT's eval with a padding mask (the attention's plain path):
    captured at its third call, bitwise the eager call; the padded
    positions' ids changed leave every logit as it was; then the f32
    eval on the card against the port on the CPU with the same
    weights."""
    from singa_tpu_torch import device
    from singa_tpu_torch.models import BERT
    cfg = m.cfg
    rng = np.random.RandomState(3)
    b, t = BERT_EVAL_B, BERT_TRAIN[1]
    ids = rng.randint(0, cfg.vocab_size, (b, t)).astype(np.int32)
    tt = np.zeros((b, t), np.int32)
    tt[:, t // 2:] = 1
    mask = np.ones((b, t), np.int32)
    mask[:, t - BERT_PAD:] = 0
    other = ids.copy()
    other[:, t - BERT_PAD:] = rng.randint(0, cfg.vocab_size, (b, BERT_PAD))
    args = [torch.as_tensor(a, device="cuda") for a in (ids, tt, mask)]
    m.eval()
    with torch.no_grad():
        m.graph_mode = False
        eager = m(*args)
        m.graph_mode = True
        outs = [m(*args) for _ in range(3)]
        padded = m(torch.as_tensor(other, device="cuda"), *args[1:])
    g = m.get_graph("eval")
    res = {"B": b, "T": t, "padded_positions": BERT_PAD,
           "logits_shape": list(eager.shape),
           "captured": g is not None and g.graph is not None,
           "captured_equals_eager": all(torch.equal(o, eager) for o in outs),
           "padding_ignored": torch.equal(padded, outs[-1]),
           "finite": bool(torch.isfinite(eager).all())}
    # f32 on the card (TF32 off) against the CPU, the same weights
    dev = m.device
    saved, dev.default_dtype = dev.default_dtype, torch.float32
    try:
        cpu = BERT(cfg, device=device.create_device("cpu"))
        cpu.set_params({n: p.detach().cpu()
                        for n, p in m.get_params().items()})
        cpu.eval()
        n = BERT_CHECK_B
        with torch.no_grad():
            m.graph_mode = False
            card = m(*(a[:n] for a in args)).float().cpu()
            host = cpu(*(torch.as_tensor(a[:n]) for a in (ids, tt, mask)))
    finally:
        dev.default_dtype = saved
        m.graph_mode = True
    err = float((card - host).abs().max() / host.abs().max())
    res["f32_vs_cpu"] = {"rows": n, "max_rel_to_largest": err,
                         "limit": BERT_F32_LOGIT}
    later(res["captured"] and res["captured_equals_eager"],
          "BERT's captured eval differs from the eager one")
    later(res["padding_ignored"], "BERT's logits moved with padded ids")
    later(res["finite"] and res["logits_shape"] == [b, cfg.num_labels],
          f"BERT's eval logits: shape {res['logits_shape']}, finite "
          f"{res['finite']}")
    later(err <= BERT_F32_LOGIT, f"BERT's f32 logits on the card differ "
          f"from the CPU's by {err} of the largest")
    return res


def _all_grads(m, x):
    """One eager step's loss and every parameter's gradient, by name
    (the path of train_one_batch up to the optimizer)."""
    from singa_tpu_torch import autograd
    params = m.get_params()
    ids_of = {id(p): n for n, p in params.items()}
    with autograd.train_mode():
        loss = _gpt2_loss(m, x)
        grads = {ids_of[id(p)]: g for p, g in autograd.backward(loss)}
    for p in params.values():
        p.grad = None
    return loss.detach(), grads


def gpt2_remat(m, later):
    """GPT-2 with remat=True beside the plain model `m` (fused loss,
    dropout 0.1, SGD(0.01, momentum 0.9)) at GPT2_TRAIN: the remat
    model's parameters loaded from `m`'s by name; from the same weights
    and dropout seed, one eager step's loss and every gradient, then
    REMAT_STEPS steps through train_step (two eager, then captured) in
    losses, parameters and the generator's state, all held bitwise;
    then REMAT_TIMED replays of each, alternating: step ms, each
    kernel's launches a step counted on the card (24/12/12 under remat),
    the graph pool, and the peak memory an eager step allocates above
    what is resident before it."""
    from singa_tpu_torch import kernel_check, opt
    from singa_tpu_torch.model import _dropout_generators
    from singa_tpu_torch.ops import flash_attention as fa
    cfg = m.cfg
    L = cfg.num_layers
    r = gpt2_model(dataclasses.replace(cfg, remat=True))
    names_equal = list(r.get_params()) == list(m.get_params())
    r.set_params(m.get_params())
    start = {n: p.detach().clone() for n, p in m.get_params().items()}
    b, t = GPT2_TRAIN
    rng = np.random.RandomState(7)
    batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, t))
                               .astype(np.int32), device="cuda")
               for _ in range(REMAT_STEPS)]
    models = {"plain": m, "remat": r}
    gens = {k: _dropout_generators(mm) for k, mm in models.items()}
    out = {k: {} for k in models}
    grads = {}
    for k, mm in models.items():
        mm.set_params(start)
        for g in gens[k]:
            g.manual_seed(0)
        loss, grads[k] = _all_grads(mm, batches[0])
        out[k]["eager_loss"] = loss.item()
        out[k]["generator_after_grads"] = [g.get_state() for g in gens[k]]
    grads_differ = [n for n in grads["plain"]
                    if not torch.equal(grads["plain"][n], grads["remat"][n])]
    missing = sorted(set(grads["plain"]) ^ set(grads["remat"]))
    del grads
    _free()
    ends = {}
    for k, mm in models.items():
        mm.set_params(start)
        for g in gens[k]:
            g.manual_seed(0)
        mm.set_optimizer(opt.SGD(lr=0.01, momentum=0.9))
        mm.compile([batches[0]], is_train=True, use_graph=True)
        losses, per_step = [], []
        for i, x in enumerate(batches):
            if i == 0:
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            fa.reset_device_launches()
            losses.append(mm.train_step(x)[1].item())
            per_step.append(fa.device_launches())
            if i == 0:
                out[k]["eager_step_peak_bytes"] = \
                    torch.cuda.max_memory_allocated() - resident
        g = mm.get_graph("train")
        out[k].update({"losses": losses, "launches_per_step": per_step,
                       "captured": g.graph is not None,
                       "graph_launches": g.launches,
                       "graph_pool_bytes": g.pool_bytes,
                       "generator_after": [x.get_state() for x in gens[k]]})
        ends[k] = {n: p.detach().clone() for n, p in mm.get_params().items()}
    params_differ = [n for n in ends["plain"]
                     if not torch.equal(ends["plain"][n], ends["remat"][n])]
    del ends, start
    _free()
    x = batches[0]
    times = {k: [] for k in models}
    for _ in range(REMAT_TIMED):
        for k, mm in models.items():
            times[k].append(_timed(lambda: mm.train_step(x))[1] * 1e3)
    for k in models:
        o = out[k]
        o["step_ms"] = times[k]
        o["median_step_ms"] = sorted(times[k])[len(times[k]) // 2]
        o["tokens_per_s"] = b * t / (o["median_step_ms"] / 1e3)
    expect = {"plain": dict.fromkeys(fa.KERNELS, L),
              "remat": kernel_check.remat_launches(L)}
    gen_equal = all(torch.equal(a, c) for a, c in zip(
        out["plain"].pop("generator_after"),
        out["remat"].pop("generator_after")))
    gen_equal_grads = all(torch.equal(a, c) for a, c in zip(
        out["plain"].pop("generator_after_grads"),
        out["remat"].pop("generator_after_grads")))
    res = {"B": b, "T": t, "config": "GPT2Config(remat=True, fused_loss="
           "True) (GPT-2 124M), dropout 0.1",
           "param_names_equal": names_equal, **out,
           "eager_step": {"loss_equal": out["plain"]["eager_loss"]
                          == out["remat"]["eager_loss"],
                          "grads_differing": grads_differ[:8],
                          "grad_names_differing": missing[:8],
                          "generator_equal": gen_equal_grads},
           "steps": {"losses_equal": out["plain"]["losses"]
                     == out["remat"]["losses"],
                     "params_differing": params_differ[:8],
                     "generator_equal": gen_equal},
           "expected_per_step": expect,
           "step_ms_ratio": out["remat"]["median_step_ms"]
           / out["plain"]["median_step_ms"],
           "eager_peak_ratio": out["remat"]["eager_step_peak_bytes"]
           / out["plain"]["eager_step_peak_bytes"],
           "pool_ratio": out["remat"]["graph_pool_bytes"]
           / out["plain"]["graph_pool_bytes"]}
    del r, models
    _free()
    later(names_equal, "GPT-2's remat parameter names differ from plain")
    later(res["eager_step"]["loss_equal"] and not grads_differ
          and not missing and gen_equal_grads,
          f"GPT-2's eager remat step differs from plain: {res['eager_step']}")
    later(res["steps"]["losses_equal"] and not params_differ and gen_equal,
          f"GPT-2's remat steps differ from plain: {res['steps']}, "
          f"losses {out['plain']['losses']} vs {out['remat']['losses']}")
    later(all(np.isfinite(out["remat"]["losses"])),
          f"GPT-2's remat losses: {out['remat']['losses']}")
    for k in ("plain", "remat"):
        o = out[k]
        later(o["captured"] and o["graph_launches"] == expect[k]
              and all(n == expect[k] for n in o["launches_per_step"]),
              f"GPT-2's {k} step launches {o['launches_per_step']} (graph "
              f"{o['graph_launches']}), expected {expect[k]} a step")
    later(res["eager_peak_ratio"] < 1 and res["pool_ratio"] < 1,
          f"GPT-2's remat step holds no less memory: eager peak ratio "
          f"{res['eager_peak_ratio']}, pool ratio {res['pool_ratio']}")
    return res


def phase_transformer():
    """GPT-2 124M: generate(), the paged engine and training; then
    BERT-base training at bench.py's cell, and its eval.  Published
    widths and depths, random weights from seed 0, bf16 activations over
    f32 masters."""
    from singa_tpu_torch import device
    from singa_tpu_torch.models import BERT, BERTConfig, GPT2Config
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    cfg = GPT2Config()
    m = gpt2_model(cfg)
    params = sum(p.numel() for p in m.get_params().values())
    gen = config_generate(m, *GPT2_GEN, later)
    slots, max_len, block, n_req, new = GPT2_SERVE
    rng = np.random.RandomState(GPT2_SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(GPT2_PROMPTS[0], GPT2_PROMPTS[1] + 1,
                                    n_req)]
    serve, eng, _, _ = config_serve(m, slots, max_len, block, prompts, new,
                                    later)
    eng.close()
    del eng
    _free()
    gaps, serve["teacher_forced_f32"] = oracle_f32_masters(
        m, prompts[:SERVE_ORACLE])
    later(float(gaps.max()) <= SERVE_DELTA, f"GPT-2's f32 engine tokens "
          f"fail the teacher-forced oracle: max gap {gaps.max()}")
    later(serve["teacher_forced_f32"]["vs_generate_f32"]["streams_equal"],
          "GPT-2's f32 engine streams differ from f32 generate()'s: "
          f"{serve['teacher_forced_f32']['vs_generate_f32']}")
    del m
    _free()

    m = gpt2_model(dataclasses.replace(cfg, fused_loss=True))
    b, t = GPT2_TRAIN
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, t))
    vs_plain = gpt2_kernel_vs_plain(m, ids.astype(np.int32))
    later(vs_plain["ok"], f"GPT-2's step with the kernels differs from "
          f"plain: {vs_plain}")
    train = config_train(m, b, t, later, cfg.num_layers)
    train["kernel_vs_plain"] = vs_plain
    # model FLOPs from the captured graph's aten count: less the fused
    # loss's recomputation of the tied head's logits in the backward
    # (2 V D a token), plus the flash kernels' FLOPs, which the count
    # leaves out (4 a causal (q, k) pair and head dim forward, 8 backward)
    head = 2 * cfg.vocab_size * cfg.dim * b * t
    hd = cfg.dim // cfg.num_heads
    attn = 12 * b * cfg.num_heads * hd * (t * (t + 1) // 2) * cfg.num_layers
    flops = train["graph_flops"] - head + attn
    train.update({
        "recomputed_head_flops": head, "attention_kernel_flops": attn,
        "flops_source": "captured graph (aten ops) - recomputed head "
                        "+ flash kernels", "flops_per_step": flops,
        "flops_per_token": flops / (b * t),
        "mfu": flops / (train["median_step_ms"] / 1e3)
        / PEAK_FLOPS[torch.bfloat16]})
    x = torch.as_tensor(ids.astype(np.int32), device="cuda")
    train["profile"] = phase_profile(
        lambda: m.train_step(x), f"one replayed GPT-2 train step, B={b} "
        f"T={t}", dict.fromkeys(fa.KERNELS, cfg.num_layers))
    del x
    remat = gpt2_remat(m, later)
    del m
    _free()

    bcfg = BERTConfig(num_labels=2)
    bm = BERT(bcfg, device=device.create_device("cuda"),
              generator=torch.Generator("cuda").manual_seed(0))
    bparams = sum(p.numel() for p in bm.get_params().values())
    bb, bt = BERT_TRAIN
    bert_train = config_train(bm, bb, bt, later, 0, bm.flops_per_token(bt),
                              make_batch=_bert_batch)
    batch = _bert_batch(np.random.RandomState(0), bcfg.vocab_size, bb, bt)
    bert_train["profile"] = phase_profile(
        lambda: bm.train_step(*batch), f"one replayed BERT-base train step, "
        f"B={bb} T={bt}", dict.fromkeys(fa.KERNELS, 0))
    fa.reset_device_launches()
    evals = bert_eval(bm, later)
    bert_launches = fa.device_launches()
    del bm, batch
    _free()
    emit({"phase": "transformer", "card": smi_line(),
          "gpt2": {"config": "GPT2Config() (GPT-2 124M)", "params": params,
                   "generate": gen, "serve": serve, "train": train,
                   "remat": remat},
          "bert": {"config": "BERTConfig(num_labels=2) (BERT-base)",
                   "params": bparams, "train": bert_train, "eval": evals,
                   "eval_flash_launches": bert_launches},
          "phase_seconds": time.perf_counter() - t0})
    later(params == 124_439_808, f"GPT-2 has {params} parameters")
    later(bparams == 109_483_778, f"BERT-base has {bparams} parameters")
    later(not any(bert_launches.values()), f"flash kernels ran in BERT's "
          f"eval: {bert_launches}")
    for cond, msg in checks:
        check(cond, msg)
    return {"gpt2": {"train": train["launches"], "generate": gen["launches"],
                     "serve": serve["flash_launches"],
                     "remat": {k: sum(n[k] for n in
                                      remat["remat"]["launches_per_step"])
                               for k in fa.KERNELS}},
            "bert": {"train": bert_train["launches"],
                     "step": {k: bert_train[k] for k in (
                         "median_step_ms", "samples_per_s", "mfu")}}}


# -- phase train_run: fault-tolerant training runs ------------------------------

def _peak_rss():
    """The process's peak resident set so far, bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def mixtral_layout(m):
    """A port MoE Llama in MixtralForCausalLM's layout, written here (to_hf
    exports no MoE): HF's Linear stores (out, in); each expert's w1 is the
    gate, w3 the up and w2 the down projection; gate.weight the router."""
    from singa_tpu_torch.models import HFLayout

    c = m.cfg
    p = {n: t.detach() for n, t in m.get_params().items()}

    def host(t):
        return t.contiguous().to("cpu", torch.float32)
    sd = {"model.embed_tokens.weight": host(p["tok_emb.table"]),
          "model.norm.weight": host(p["norm_f.gamma"]),
          "lm_head.weight": host(p["lm_head.W"].T)}
    for i in range(c.num_layers):
        our, hfp = f"blocks.{i}.", f"model.layers.{i}."
        sd[hfp + "input_layernorm.weight"] = host(p[our + "attn_norm.gamma"])
        sd[hfp + "post_attention_layernorm.weight"] = host(
            p[our + "ffn_norm.gamma"])
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{hfp}self_attn.{proj}.weight"] = host(
                p[f"{our}attn.{proj}.W"].T)
        moe = hfp + "block_sparse_moe."
        sd[moe + "gate.weight"] = host(p[our + "ffn.router"].T)
        for theirs, ours in (("w1", "w_gate"), ("w3", "w_in"),
                             ("w2", "w_out")):
            for e in range(c.num_experts):
                sd[f"{moe}experts.{e}.{theirs}.weight"] = host(
                    p[f"{our}ffn.{ours}"][e].T)
    fields = dict(
        vocab_size=c.vocab_size, hidden_size=c.dim,
        intermediate_size=c.ffn_dim, num_hidden_layers=c.num_layers,
        num_attention_heads=c.num_heads, num_key_value_heads=c.num_kv_heads,
        max_position_embeddings=c.max_position, rope_theta=c.rope_theta,
        rms_norm_eps=c.eps, num_local_experts=c.num_experts,
        num_experts_per_tok=c.moe_top_k,
        sliding_window=c.sliding_window or None,
        router_aux_loss_coef=c.moe_aux_weight)
    return HFLayout("MixtralForCausalLM", fields, sd)


def hf_round_trip(src, what, later, export=None, gen=HF_GEN):
    """`src` exported to the HF layout (`export`, default models.hf_layout)
    and imported on its device by its architecture's importer
    (from_hf_llama, from_hf_mistral or from_hf_mixtral, through from_hf's
    dispatch on the layout's architecture): the
    parameters and the configuration must equal the source's, the logits
    on one seeded batch and the greedy generate() stream at `gen` must be
    bitwise the source's, and each generate() call must launch the flash
    forward once a layer, counted on the card.  (result, the import)."""
    from singa_tpu_torch.models import convert
    from singa_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    layout, export_s = _timed(lambda: (export or convert.hf_layout)(src))
    sd_bytes = sum(t.numel() * t.element_size()
                   for t in layout.state_dict().values())
    arch = layout.architecture
    dst, import_s = _timed(lambda: convert.from_hf(layout,
                                                   device=src.device))
    del layout
    gc.collect()
    sp, dp = src.get_params(), dst.get_params()
    differ = [n for n in sp if n not in dp or not torch.equal(sp[n], dp[n])]
    cs, cd = dataclasses.asdict(src.cfg), dataclasses.asdict(dst.cfg)
    if not cs["rope_scaling"] and not cd["rope_scaling"]:
        # unread without scaling: the importer sets it to the checkpoint's
        # max_position_embeddings, as the reference's does
        cs.pop("rope_scaling_original_max_position")
        cd.pop("rope_scaling_original_max_position")
    cfg_differs = sorted(k for k in cs if cs[k] != cd[k])
    b, p, n = gen
    prompts = np.random.RandomState(HF_SEED).randint(
        0, src.cfg.vocab_size, (b, p))
    ids = torch.as_tensor(prompts, dtype=torch.int32,
                          device=src.device.torch_device)
    src.eval()
    dst.eval()
    with torch.no_grad():
        lg_src, lg_dst = src(ids), dst(ids)
    logits_bitwise = bool(torch.equal(lg_src, lg_dst))
    finite = bool(torch.isfinite(lg_src).all())
    del lg_src, lg_dst
    kw = dict(max_new_tokens=n, param_dtype=torch.bfloat16)
    launches, streams = {}, {}
    for which, m in (("source", src), ("imported", dst)):
        fa.reset_device_launches()
        streams[which] = m.generate(prompts, **kw)
        launches[which] = fa.device_launches()
    expect = {"flash_fwd": src.cfg.num_layers, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0}
    res = {"model": what, "architecture": arch, "params": src.num_params(),
           "layers": src.cfg.num_layers, "state_dict_bytes": sd_bytes,
           "export_s": export_s, "import_s": import_s,
           "params_bitwise": not differ and list(sp) == list(dp),
           "config_differs": cfg_differs,
           "logits": {"B": b, "T": p, "bitwise": logits_bitwise,
                      "finite": finite},
           "generate": {"B": b, "P": p, "N": n, "param_dtype": "bfloat16",
                        "tokens_equal": bool(np.array_equal(
                            streams["source"], streams["imported"])),
                        "launches": launches, "expected_launches": expect},
           "peak_rss_bytes": _peak_rss(),
           "card_peak_bytes": torch.cuda.max_memory_allocated()}
    later(res["params_bitwise"], f"{what}: imported parameters differ "
          f"from the source's: {differ[:8]}")
    later(not cfg_differs, f"{what}: the imported config differs from the "
          f"source's in {cfg_differs}: {dst.cfg}")
    later(logits_bitwise and finite, f"{what}: imported logits are not "
          f"bitwise the source's (finite: {finite})")
    later(res["generate"]["tokens_equal"], f"{what}: the imported model's "
          f"greedy stream differs from the source's")
    later(all(v == expect for v in launches.values()), f"{what}: "
          f"generate() launched {launches}, expected {expect} a call")
    later(streams["source"].shape == (b, p + n)
          and (streams["source"][:, :p] == prompts).all(),
          f"{what}: generate returned a wrong shape or prompt")
    return res, dst


def hf_train(src, dst, later):
    """HF_STEPS eager steps of `src` and of its import `dst` from the same
    weights on the same batches (HF_TRAIN, SGD 0.01 / momentum 0.9):
    losses and parameters after them bitwise; each flash kernel once a
    layer a step, counted on the card."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(HF_SEED + 1)
    b, t = HF_TRAIN
    batches = [_token_batch(rng, src.cfg.vocab_size, b, t)
               for _ in range(HF_STEPS)]
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for which, m in (("source", src), ("imported", dst)):
        m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9))
        m.compile(list(batches[0]), is_train=True, use_graph=False)
        fa.reset_device_launches()
        losses, dt = _timed(lambda: [m.train_step(*bt)[1].item()
                                     for bt in batches])
        runs[which] = {"losses": losses, "launches": fa.device_launches(),
                       "seconds": dt}
    sp, dp = src.get_params(), dst.get_params()
    differ = [n for n in sp if not torch.equal(sp[n], dp[n])]
    expect = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                           src.cfg.num_layers * HF_STEPS)
    out = {"B": b, "T": t, "steps": HF_STEPS,
           "window": src.cfg.sliding_window,
           "optimizer": _opt_name(src.optimizer), "runs": runs,
           "losses_bitwise": (runs["source"]["losses"]
                              == runs["imported"]["losses"]),
           "params_bitwise": not differ, "expected_launches": expect,
           "card_peak_bytes": torch.cuda.max_memory_allocated()}
    later(out["losses_bitwise"], f"the imported mistral's losses "
          f"{runs['imported']['losses']} differ from the source's "
          f"{runs['source']['losses']}")
    later(not differ, f"parameters after the steps differ: {differ[:8]}")
    later(all(r["launches"] == expect for r in runs.values()),
          f"the steps launched {[r['launches'] for r in runs.values()]}, "
          f"expected {expect}")
    later(np.isfinite(runs["source"]["losses"]).all(),
          f"non-finite loss: {runs['source']['losses']}")
    return out


def park(m):
    """Keep `m` for a later phase off the card: its generate() sessions
    and their weight copy dropped, its parameters moved to the host."""
    m._gen_sessions.clear()
    m._gen_params.clear()
    m.to("cpu")


def phase_hf(m):
    """Each model through the HF layout and back on the card: the slice
    phase's base() (`m`, parked on the host since the beam phase),
    mistral-w4096 and mixtral-8x7b cut in depth; the imported mistral
    also trains."""
    from singa_tpu_torch.models.llama import PUBLISHED

    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    m.to("cuda")
    res, dst = hf_round_trip(m, "base", later)
    res["source"] = "LlamaConfig.base(), the slice phase's model"
    emit({"phase": "hf", **res})
    results = {"base": res}
    del dst
    park(m)
    _free()
    for name, layers in HF_LAYERS.items():
        cfg = dataclasses.replace(PUBLISHED[name], num_layers=layers)
        src = config_model(cfg)
        res, dst = hf_round_trip(
            src, name, later,
            export=mixtral_layout if cfg.num_experts else None)
        published = ("Mixtral-8x7B-v0.1" if cfg.num_experts
                     else "Mistral-7B-v0.1")
        res["source"] = f"{published} config.json, 32 -> {layers} layers"
        if name == "mistral-w4096":
            res["train"] = hf_train(src, dst, later)
        emit({"phase": "hf", **res})
        results[name] = res
        del src, dst
        _free()
    emit({"phase": "hf", "models": list(results),
          "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return results


def tensor_checks(dev, shape=TENSOR_SHAPE):
    """Every function of singa_tpu_torch.tensor once on `dev` at `shape`
    (f32) against numpy: [{name, kind, ok, err}] (kind: exact, elem,
    sum, stat or value, held to the tensor phase's limits)."""
    from singa_tpu_torch import tensor as T

    r, c = shape
    rng = np.random.RandomState(3)
    f32 = np.float32
    A, B = rng.randn(r, c).astype(f32), rng.randn(r, c).astype(f32)
    P = (np.abs(rng.randn(r, c)) + 0.5).astype(f32)
    R = (rng.randn(r, c) * 3).astype(f32)
    M = rng.randn(c, 256).astype(f32)
    Vr, Vc = rng.randn(r).astype(f32), rng.randn(c).astype(f32)
    Q = rng.randn(8, r // 8, c // 8).astype(f32)
    K = rng.randn(8, c // 8, 64).astype(f32)
    I = rng.randint(0, 3, (r, c)).astype(f32)
    J = rng.randint(0, 3, (r, c)).astype(f32)
    d = {k: v.astype(np.float64) for k, v in
         dict(A=A, B=B, P=P, M=M, Q=Q, K=K).items()}

    def x(a):
        return T.from_numpy(a, dev)

    def copied():
        dst = T.zeros(shape, dev, torch.float32)
        T.copy_data_to_from(dst, x(A.ravel()))
        return dst

    def seeded():
        draws = []
        for _ in range(2):
            T.set_seed(5)
            draws.append(T.gaussian((1024,), dev=dev, dtype=torch.float32))
        return bool(torch.equal(*draws))

    def softmax64(a):
        e = np.exp(a - a.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def mask(a):
        return a.astype(f32)

    cases = {
        "from_numpy": ("exact", lambda: x(A), lambda: A),
        "to_numpy": ("exact", lambda: T.to_numpy(x(A)), lambda: A),
        "from_raw": ("exact", lambda: T.from_raw(torch.from_numpy(A), dev),
                     lambda: A),
        "zeros": ("exact", lambda: T.zeros(shape, dev, torch.float32),
                  lambda: np.zeros(shape, f32)),
        "ones": ("exact", lambda: T.ones(shape, dev, torch.float32),
                 lambda: np.ones(shape, f32)),
        "full": ("exact", lambda: T.full(shape, 2.5, dev, torch.float32),
                 lambda: np.full(shape, 2.5, f32)),
        "zeros_like": ("exact", lambda: T.zeros_like(x(A)),
                       lambda: np.zeros_like(A)),
        "ones_like": ("exact", lambda: T.ones_like(x(A)),
                      lambda: np.ones_like(A)),
        "arange": ("exact", lambda: T.arange(0, r * c, 7, dev),
                   lambda: np.arange(0, r * c, 7, dtype=np.int32)),
        "eye": ("exact", lambda: T.eye(c, dev, torch.float32),
                lambda: np.eye(c, dtype=f32)),
        "copy_data_to_from": ("exact", copied, lambda: A),
        "set_seed": ("value", seeded, lambda: True),
        "default_float": ("value", lambda: T.default_float(dev),
                          lambda: dev.default_dtype),
        "reshape": ("exact", lambda: T.reshape(x(A), (c, r)),
                    lambda: A.reshape(c, r)),
        "transpose": ("exact", lambda: T.transpose(x(A)), lambda: A.T),
        "flatten": ("exact", lambda: T.flatten(x(Q), 1),
                    lambda: Q.reshape(8, -1)),
        "squeeze": ("exact", lambda: T.squeeze(x(A[None, :, None])),
                    lambda: A),
        "unsqueeze": ("exact", lambda: T.unsqueeze(x(A), 1),
                      lambda: A[:, None]),
        "concatenate": ("exact", lambda: T.concatenate([x(A), x(B)], 1),
                        lambda: np.concatenate([A, B], 1)),
        "stack": ("exact", lambda: T.stack([x(A), x(B)], 0),
                  lambda: np.stack([A, B], 0)),
        "split": ("exact", lambda: T.split(x(A), 4, 1),
                  lambda: np.split(A, 4, 1)),
        "repeat": ("exact", lambda: T.repeat(x(A), 2, 1),
                   lambda: np.repeat(A, 2, 1)),
        "abs": ("exact", lambda: T.abs(x(A)), lambda: np.abs(A)),
        "sign": ("exact", lambda: T.sign(x(A)), lambda: np.sign(A)),
        "relu": ("exact", lambda: T.relu(x(A)), lambda: np.maximum(A, 0)),
        "ceil": ("exact", lambda: T.ceil(x(R)), lambda: np.ceil(R)),
        "floor": ("exact", lambda: T.floor(x(R)), lambda: np.floor(R)),
        "round": ("exact", lambda: T.round(x(R)), lambda: np.round(R)),
        "max": ("exact", lambda: T.max(x(A), 1), lambda: A.max(1)),
        "min": ("exact", lambda: T.min(x(A)), lambda: A.min()),
        "argmax": ("exact", lambda: T.argmax(x(A), 1),
                   lambda: A.argmax(1).astype(np.int32)),
        "argmin": ("exact", lambda: T.argmin(x(A), 0),
                   lambda: A.argmin(0).astype(np.int32)),
        "clip": ("exact", lambda: T.clip(x(A), -0.5, 0.5),
                 lambda: np.clip(A, -0.5, 0.5)),
        "lt": ("exact", lambda: T.lt(x(A), x(B)), lambda: mask(A < B)),
        "le": ("exact", lambda: T.le(x(A), 0.0), lambda: mask(A <= 0)),
        "gt": ("exact", lambda: T.gt(x(I), x(J)), lambda: mask(I > J)),
        "ge": ("exact", lambda: T.ge(x(I), x(J)), lambda: mask(I >= J)),
        "eq": ("exact", lambda: T.eq(x(I), x(J)), lambda: mask(I == J)),
        "add": ("elem", lambda: T.add(x(A), x(B)), lambda: d["A"] + d["B"]),
        "sub": ("elem", lambda: T.sub(x(A), x(B)), lambda: d["A"] - d["B"]),
        "mul": ("elem", lambda: T.mul(x(A), x(B)), lambda: d["A"] * d["B"]),
        "div": ("elem", lambda: T.div(x(A), x(P)), lambda: d["A"] / d["P"]),
        "eltwise_mult": ("elem", lambda: T.eltwise_mult(x(A), x(B)),
                         lambda: d["A"] * d["B"]),
        "axpy": ("elem", lambda: T.axpy(2.5, x(A), x(B)),
                 lambda: d["B"] + 2.5 * d["A"]),
        "add_column": ("elem", lambda: T.add_column(x(Vr), x(A)),
                       lambda: d["A"] + Vr[:, None]),
        "add_row": ("elem", lambda: T.add_row(x(Vc), x(A)),
                    lambda: d["A"] + Vc[None, :]),
        "square": ("elem", lambda: T.square(x(A)), lambda: d["A"] ** 2),
        "exp": ("elem", lambda: T.exp(x(A)), lambda: np.exp(d["A"])),
        "log": ("elem", lambda: T.log(x(P)), lambda: np.log(d["P"])),
        "sqrt": ("elem", lambda: T.sqrt(x(P)), lambda: np.sqrt(d["P"])),
        "pow": ("elem", lambda: T.pow(x(P), 1.5), lambda: d["P"] ** 1.5),
        "tanh": ("elem", lambda: T.tanh(x(A)), lambda: np.tanh(d["A"])),
        "sigmoid": ("elem", lambda: T.sigmoid(x(A)),
                    lambda: 1 / (1 + np.exp(-d["A"]))),
        "softmax": ("sum", lambda: T.softmax(x(A), -1),
                    lambda: softmax64(d["A"])),
        "sum": ("sum", lambda: T.sum(x(A), 1, True),
                lambda: d["A"].sum(1, keepdims=True)),
        "sum_all": ("sum", lambda: T.sum_all(x(A)), lambda: d["A"].sum()),
        "sum_columns": ("sum", lambda: T.sum_columns(x(A)),
                        lambda: d["A"].sum(1)),
        "sum_rows": ("sum", lambda: T.sum_rows(x(A)),
                     lambda: d["A"].sum(0)),
        "mean": ("sum", lambda: T.mean(x(A), 0), lambda: d["A"].mean(0)),
        "matmul": ("sum", lambda: T.matmul(x(A), x(M)),
                   lambda: d["A"] @ d["M"]),
        "mult": ("sum", lambda: T.mult(x(A), x(M)), lambda: d["A"] @ d["M"]),
        "tensordot": ("sum", lambda: T.tensordot(x(A), x(M), 1),
                      lambda: np.tensordot(d["A"], d["M"], 1)),
        "batchmatmul": ("sum", lambda: T.batchmatmul(x(Q), x(K)),
                        lambda: d["Q"] @ d["K"]),
        "einsum": ("sum", lambda: T.einsum("ij,jk->ik", x(A), x(M)),
                   lambda: d["A"] @ d["M"]),
        "gaussian": ("stat", lambda: T.gaussian(shape, 1.0, 2.0, dev,
                                                torch.float32),
                     lambda: (1.0, 2.0)),
        "uniform": ("stat", lambda: T.uniform(shape, -1.0, 3.0, dev,
                                              torch.float32),
                    lambda: (1.0, 4 / 12 ** 0.5)),
        "bernoulli": ("stat", lambda: T.bernoulli(shape, 0.3, dev,
                                                  torch.float32),
                      lambda: (0.3, (0.3 * 0.7) ** 0.5)),
    }
    rows = []
    for name, (kind, got_fn, want_fn) in cases.items():
        got, want = got_fn(), want_fn()
        if kind == "value":
            ok, err = got == want, None
        elif kind == "stat":
            g = got.double()
            err = max(abs(g.mean().item() - want[0]),
                      abs(g.std().item() - want[1]))
            ok = got.device == dev.torch_device and err <= TENSOR_STAT_TOL
        else:
            outs = list(got) if isinstance(got, (list, tuple)) else [got]
            wants = list(want) if isinstance(want, list) else [want]
            on = all(not isinstance(o, torch.Tensor)
                     or o.device == dev.torch_device for o in outs)
            outs = [T.to_numpy(o) if isinstance(o, torch.Tensor)
                    else np.asarray(o) for o in outs]
            if kind == "exact":
                err = None
                ok = on and len(outs) == len(wants) and all(
                    o.dtype == w.dtype and np.array_equal(o, w)
                    for o, w in zip(outs, wants))
            else:
                (o,), (w,) = outs, wants
                err = float(np.abs(o - w).max() / np.abs(w).max())
                tol = TENSOR_RTOL if kind == "elem" else TENSOR_SUM_RTOL
                ok = (on and o.shape == np.shape(w)
                      and (o.dtype == f32 or o.ndim == 0) and err <= tol)
        rows.append({"name": name, "kind": kind, "ok": bool(ok),
                     "err": err})
    return rows


def phase_tensor():
    """singa_tpu_torch.tensor on the card: every module function once at
    base()'s widths against numpy (`tensor_checks`)."""
    from singa_tpu_torch import device
    from singa_tpu_torch import tensor as T

    t0 = time.perf_counter()
    dev = device.create_device("auto")
    rows = tensor_checks(dev)
    bad = [r for r in rows if not r["ok"]]
    emit({"phase": "tensor", "device": str(dev.torch_device),
          "shape": list(TENSOR_SHAPE), "dtype": "float32",
          "functions": len(rows), "agreed": len(rows) - len(bad),
          "disagreed": bad,
          "max_rel_err": {r["name"]: r["err"] for r in rows
                          if r["kind"] in ("elem", "sum")},
          "phase_seconds": time.perf_counter() - t0})
    public = set(T.__all__) - {"Tensor"}
    named = {r["name"] for r in rows}
    check(named == public, f"tensor functions without a case: "
          f"{sorted(public - named)}")
    check(not bad, f"tensor functions disagree with numpy: {bad}")


def train_run_model():
    """The train_run phase's model and loader: GPT-2 124M's widths
    (GPT2Config() cut to RUN_LAYERS layers, fused loss, dropout 0.1) on
    the card with f32 masters from seed 0,
    AdamW(RUN_LR, weight decay RUN_WD), compiled at GPT2_TRAIN; a
    DataLoader over RUN_SEQS synthetic sequences of int32 ids
    (RUN_DATA_SEED), batch B, shuffle seed 1, drop_last.  The same in
    every process that calls it (the children import it by name)."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.models import GPT2Config
    from singa_tpu_torch.utils.data import DataLoader
    b, t = GPT2_TRAIN
    m = gpt2_model(dataclasses.replace(GPT2Config(), fused_loss=True,
                                       num_layers=RUN_LAYERS))
    m.set_optimizer(opt.AdamW(lr=RUN_LR, weight_decay=RUN_WD))
    data = np.random.RandomState(RUN_DATA_SEED).randint(
        0, m.cfg.vocab_size, (RUN_SEQS, t)).astype(np.int32)
    m.compile([torch.as_tensor(data[:b], device=m.device.torch_device)],
              is_train=True, use_graph=True)
    return m, DataLoader(data, batch_size=b, shuffle=True, seed=1,
                         drop_last=True)


def run_digest(m):
    """sha256 over a model's run state: parameters and buffers, the
    optimizer's moments, its step counter and the step's generators'
    states."""
    import hashlib
    from singa_tpu_torch.train.state import step_generators
    h = hashlib.sha256()
    for n, t in sorted(m.get_states().items()):
        h.update(n.encode())
        h.update(t.detach().cpu().numpy().tobytes())
    for n, leaves in sorted(m.optimizer.slot_arrays().items()):
        for i, leaf in enumerate(leaves):
            h.update(f"{n}/{i}".encode())
            h.update(leaf.detach().cpu().numpy().tobytes())
    h.update(str(m.optimizer.step_counter).encode())
    for g in step_generators(m):
        h.update(g.get_state().numpy().tobytes())
    return h.hexdigest()


def train_run_child(arg):
    """One child of phase train_run, in a fresh interpreter: the model
    and loader from the builder the spec names, a TrainRunner over them;
    one JSON line a step done, and one with the result.  Spec keys:
    builder, dir (the checkpoint directory, or None), store, events, and
    optionally prewarm (three steps before the runner, so the watchdog
    starts on replays) and step_timeout."""
    import importlib
    from singa_tpu_torch.obs import events
    from singa_tpu_torch.train import AsyncCheckpointManager, TrainRunner
    spec = json.loads(arg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    events.configure(path=spec["events"])
    mod, name = spec["builder"].split(":")
    m, loader = getattr(importlib.import_module(mod), name)()
    if spec.get("prewarm"):
        x = torch.as_tensor(loader.x[:loader.batch_size],
                            device=m.device.torch_device)
        for _ in range(3):
            m.train_step(x)
    ckpt = (AsyncCheckpointManager(spec["dir"], **RUN_CKPT)
            if spec.get("dir") else None)
    losses = {}

    def on_step(step, outs):
        losses[step] = outs[1]
        emit({"step_done": step + 1})
    r = TrainRunner(m, loader, RUN_STEPS, ckpt=ckpt,
                    record_store=spec["store"],
                    step_timeout=spec.get("step_timeout"), on_step=on_step)
    res = r.run()
    emit({"returned": res.outcome})
    r.__exit__()
    events.configure()
    emit({"result": {**dataclasses.asdict(res),
                     "losses": {str(s): float(v) for s, v in losses.items()},
                     "digest": run_digest(m)}})
    return 0


class _Child:
    """A child of phase train_run: `train_run_child(spec)` in a fresh
    interpreter from the repository's root, its stdout's JSON lines
    read on a thread and stamped with the parent's clock; stderr goes
    to a file beside its events.  A context manager: leaving it kills
    the child if it still runs."""

    def __init__(self, spec, env=None):
        import queue
        import threading
        root = Path(__file__).resolve().parent
        e = {k: v for k, v in os.environ.items() if k != "SINGA_FAULTS"}
        e["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(root), os.environ.get("PYTHONPATH")) if p)
        e.update(env or {})
        self.name = spec["name"]
        self.err_path = spec["events"] + ".stderr"
        self.err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke as c; "
             "sys.exit(c.train_run_child(sys.argv[1]))", json.dumps(spec)],
            cwd=root, env=e, stdout=subprocess.PIPE, stderr=self.err,
            text=True)
        self.lines = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            self.lines.put((time.perf_counter(), obj))
        self.lines.put((time.perf_counter(), None))

    def tail(self):
        self.err.flush()
        return Path(self.err_path).read_text()[-3000:]

    def wait_for(self, pred, timeout=RUN_CHILD_TIMEOUT_S):
        """(parent time, line) of the first line for which pred holds;
        raises if the child ends or the time runs out first."""
        import queue
        deadline = time.perf_counter() + timeout
        while True:
            try:
                t, obj = self.lines.get(
                    timeout=max(0.01, deadline - time.perf_counter()))
            except queue.Empty:
                raise AssertionError(f"train_run child {self.name} said "
                                     f"nothing for {timeout} s: "
                                     f"{self.tail()}") from None
            if obj is None:
                raise AssertionError(
                    f"train_run child {self.name} ended (rc "
                    f"{self.proc.wait()}) before the line awaited: "
                    f"{self.tail()}")
            if pred(obj):
                return t, obj

    def result(self):
        _, obj = self.wait_for(lambda o: "result" in o)
        rc = self.proc.wait(timeout=RUN_CHILD_TIMEOUT_S)
        check(rc == 0, f"train_run child {self.name} exited {rc}: "
                       f"{self.tail()}")
        res = obj["result"]
        res["losses"] = {int(s): v for s, v in res["losses"].items()}
        return res

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()
        return False


def _spans(path, name):
    """The spans called `name` in an events file: (start, end, dur_ms)
    on the wall clock."""
    out = []
    if not Path(path).exists():
        return out
    for line in Path(path).read_text().splitlines():
        ev = json.loads(line)
        if ev.get("kind") == "span" and ev.get("name") == name:
            out.append((ev["t"] - ev["dur_ms"] / 1e3, ev["t"], ev["dur_ms"]))
    return out


def _counters(path, name):
    """How many counters called `name` an events file holds."""
    events = [json.loads(line) for line in Path(path).read_text()
              .splitlines()] if Path(path).exists() else []
    return sum(1 for ev in events
               if ev.get("kind") == "counter" and ev.get("name") == name)


def _aux_of(path):
    """The json aux of a checkpoint file, read without its arrays."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
    return json.loads(meta["__aux__"])


def _resumed_alike(res, want, start, what, later):
    """Gate a resumed child against the uninterrupted run U: resumed
    from `start`, its losses from there and its final digest bitwise."""
    got = {s: v for s, v in res["losses"].items() if s >= start}
    same = {s: want["losses"][s] for s in got}
    out = {"resumed_from": res["resumed_from"], "steps": res["steps"],
           "outcome": res["outcome"],
           "losses_bitwise": got == same and len(got) == RUN_STEPS - start,
           "digest_bitwise": res["digest"] == want["digest"]}
    later(res["resumed_from"] == start and res["outcome"] == "completed"
          and res["steps"] == RUN_STEPS, f"{what}: resumed {out}, not from "
          f"{start} to {RUN_STEPS}")
    later(out["losses_bitwise"], f"{what}: losses from step {start} "
          f"{got} differ from U's {same}")
    later(out["digest_bitwise"], f"{what}: the final state's sha256 "
          f"differs from U's")
    return out


def _stamp(dev):
    """A point on the device's timeline: a recorded CUDA event on the
    card, the host clock on the CPU."""
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _ms(a, b):
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
        else (b - a) * 1e3


def _event_timed(step, dev):
    """One call of `step` with the card idle at its start, between CUDA
    events recorded around it, as U's calls are timed: (ms, host ms),
    the second the call's own time on the host's clock."""
    fence = torch.cuda.synchronize if dev.type == "cuda" else \
        (lambda _: None)
    fence(dev)
    t, h = _stamp(dev), time.perf_counter()
    step()
    h = (time.perf_counter() - h) * 1e3
    end = _stamp(dev)
    fence(dev)
    return _ms(t, end), h


def train_run_u(tmp, store, later):
    """Run U, uninterrupted, in this process: losses, digest, commits,
    launches counted on the card, step and checkpoint times; then the
    measuring tools over its captured step.  Two step times: each
    train_step call's, between CUDA events recorded around it (the
    replay as the runner calls it; the card waits for the call's host
    work, as on_step fences each step), and the run's, between the ends
    of consecutive steps on the host's clock (the runner's own host
    work between steps included: with telemetry on, its loss gauge
    fetches each step's loss, so the card waits for that work).

    The tools' gate compares like with like: `windowed_steps` against
    RUN_BESIDE replays timed as U's calls are, right beside it with no
    runner and no checkpoint write in flight.  U's own replay medians,
    all and those of steps no train.ckpt.write span overlaps, are
    reported beside them."""
    from singa_tpu_torch.obs import events
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.train import AsyncCheckpointManager, TrainRunner
    from singa_tpu_torch.utils import metrics, profiler, timing
    m, loader = train_run_model()
    dev = m.device.torch_device
    cuda = dev.type == "cuda"
    ev = str(tmp / "u.events.jsonl")
    events.configure(path=ev)
    losses, marks, calls = {}, {}, []
    call = m.train_step

    def timed_call(*batch):
        t, h = _stamp(dev), time.perf_counter()
        out = call(*batch)
        h = (time.perf_counter() - h) * 1e3
        calls.append((t, _stamp(dev), h))
        return out
    m.train_step = timed_call

    def on_step(step, outs):
        if cuda:
            torch.cuda.synchronize(dev)
        marks[step] = time.perf_counter()
        losses[step] = outs[1]
    if cuda:
        fa.reset_device_launches()
    ckpt = AsyncCheckpointManager(str(tmp / "u"), **RUN_CKPT)
    r = TrainRunner(m, loader, RUN_STEPS, ckpt=ckpt, record_store=store,
                    on_step=on_step)
    res = r.run()
    r.__exit__()
    del m.train_step
    launches = fa.device_launches() if cuda else None
    events.configure()
    digest = run_digest(m)
    out = {"run": "U", "outcome": res.outcome, "steps": res.steps,
           "losses": {s: float(v) for s, v in losses.items()},
           "digest": digest, "committed_steps": ckpt.steps(),
           "ckpt_count": res.ckpt_count, "flash_launches": launches,
           "captured": m.get_graph("train").graph is not None
           if cuda else None}
    save_every = RUN_CKPT["save_every"]
    # step k's interval runs from step k-1's fence to its own; a save
    # after `save_every` steps lies in the next step's interval.  Steps
    # from index 3 on are replays (calls 0-1 eager, 2 the capture)
    gaps = {k: (marks[k] - marks[k - 1]) * 1e3 for k in range(1, RUN_STEPS)}
    saving = [gaps[k] for k in gaps if k % save_every == 0]
    run_steps = [gaps[k] for k in gaps if k >= 3 and k % save_every]
    replays = [_ms(a, b) for a, b, _ in calls[3:]]
    snaps = _spans(ev, "train.ckpt.snapshot")
    writes = _spans(ev, "train.ckpt.write")
    steps = _spans(ev, "train.step")
    overlapping = [w for w in writes
                   if any(s0 < w[1] and w[0] < s1 for s0, s1, _ in steps)]
    inside = sum(1 for s0, s1, _ in steps
                 if any(w0 < s0 and s1 < w1 for w0, w1, _ in writes))
    # the replayed steps no write span overlaps (U retries nothing, so
    # its k-th train.step span is its k-th call)
    quiet = [k for k in range(3, len(calls)) if k < len(steps)
             and not any(w0 < steps[k][1] and steps[k][0] < w1
                         for w0, w1, _ in writes)]
    path = Path(ckpt.path(RUN_STEPS))
    out.update({
        "replay_step_ms_median": float(np.median(replays)),
        "replay_step_ms": replays,
        "replay_host_ms": [h for _, _, h in calls[3:]],
        "quiet_steps": quiet,
        "quiet_replay_step_ms_median":
            float(np.median([replays[k - 3] for k in quiet]))
            if quiet else None,
        "run_step_ms_median": float(np.median(run_steps)),
        "run_step_ms": run_steps, "saving_step_ms": saving,
        "snapshot_ms": [d for _, _, d in snaps],
        "write_s": [d / 1e3 for _, _, d in writes],
        "checkpoint_bytes": path.stat().st_size,
        "write_spans": len(writes),
        "write_spans_overlapping_steps": len(overlapping),
        "step_spans_inside_writes": inside})
    later(res.outcome == "completed" and res.steps == RUN_STEPS,
          f"U ended {res}")
    later(all(math.isfinite(v) for v in out["losses"].values())
          and len(out["losses"]) == RUN_STEPS, f"U's losses {out['losses']}")
    later(out["committed_steps"] == [16, 24] and res.ckpt_count == 3,
          f"U committed {out['committed_steps']} ({res.ckpt_count} "
          f"commits), not [16, 24] after 3")
    later(len(writes) == 3 and len(overlapping) >= 1, f"U's writes "
          f"{writes} overlap no train.step span")
    if cuda:
        later(out["captured"], "U's step was not captured")
        want = dict.fromkeys(fa.KERNELS, m.cfg.num_layers * RUN_STEPS)
        later(launches == want, f"U launched {launches}, not {want}")

    # the measuring tools over U's captured step, and beside them the
    # phase's own replay timing on the same footing
    b, t = GPT2_TRAIN
    x = torch.as_tensor(loader.x[:b], device=dev)
    sec, stats = timing.windowed_steps(lambda: m.train_step(x)[1],
                                       windows=5, window_len=4, warmup=1)
    fenced, fstats = timing.fenced_steps(lambda: m.train_step(x)[1],
                                         steps=8, warmup=1)
    beside = [_event_timed(lambda: m.train_step(x), dev)
              for _ in range(RUN_BESIDE)]
    beside_ms = float(np.median([ms for ms, _ in beside]))
    trace_dir = tmp / "trace"
    with profiler.device_trace(str(trace_dir)):
        m.train_step(x)
        m.train_step(x)
    traces = sorted(trace_dir.glob("*.json"))
    fpt = m.flops_per_token(t)
    median_s = out["replay_step_ms_median"] / 1e3
    quiet_ms = out["quiet_replay_step_ms_median"]
    tools = {"windowed_ms": sec * 1e3, "windowed": stats,
             "replay_ms_beside": [ms for ms, _ in beside],
             "replay_host_ms_beside": [h for _, h in beside],
             "replay_median_beside": beside_ms,
             "vs_replay_median": sec * 1e3 / beside_ms - 1,
             "vs_u_replay_median": sec / median_s - 1,
             "vs_u_quiet_replay_median":
                 sec * 1e3 / quiet_ms - 1 if quiet_ms else None,
             "fenced_ms": fenced * 1e3, "fenced": fstats,
             "limit": RUN_WINDOW_TOL,
             "trace_files": [p.name for p in traces],
             "trace_bytes": sum(p.stat().st_size for p in traces),
             "flops_per_token": fpt,
             "tokens_per_s": b * t / median_s}
    if cuda:
        tools["mfu"] = metrics.mfu(fpt * b * t, median_s)
        tools["peak_hbm_bw"] = metrics.peak_hbm_bw()
    later(abs(tools["vs_replay_median"]) <= RUN_WINDOW_TOL,
          f"windowed_steps {tools['windowed_ms']} ms against the replay "
          f"median beside it {beside_ms} ms")
    later(tools["trace_bytes"] > 0, f"device_trace wrote {traces}")
    out["params"] = sum(p.numel() for p in m.get_params().values())
    del m, loader, x, r, ckpt
    _free()
    return out, tools


def train_run_preempt_first(tmp, base, later):
    """P, first child: SIGTERMed once it reports RUN_PREEMPT_AFTER steps
    done, it checkpoints at its completed step and exits."""
    import signal
    from singa_tpu_torch.train import AsyncCheckpointManager
    t0 = time.perf_counter()
    spec = dict(base, name="P1", dir=str(tmp / "p"),
                events=str(tmp / "p1.events.jsonl"))
    with _Child(spec) as c:
        c.wait_for(lambda o: o.get("step_done", 0) >= RUN_PREEMPT_AFTER)
        t_term = time.perf_counter()
        c.proc.send_signal(signal.SIGTERM)
        t_ret, _ = c.wait_for(lambda o: "returned" in o)
        first = c.result()
        exit_s = time.perf_counter() - t_term
    committed = AsyncCheckpointManager(spec["dir"]).steps()
    later(first["outcome"] == "preempted"
          and first["steps"] >= RUN_PREEMPT_AFTER
          and committed and committed[-1] == first["steps"],
          f"P's first child: {first['outcome']} after {first['steps']} "
          f"steps, commits {committed}")
    return {"spec": spec, "first": first, "committed": committed,
            "sigterm_to_return_s": t_ret - t_term,
            "sigterm_to_exit_s": exit_s, "wall_s": time.perf_counter() - t0}


def train_run_preempt_resume(tmp, u, p, later):
    """P, second child: resumes from the preemption's checkpoint."""
    t0 = time.perf_counter()
    first, done = p["first"], p["first"]["steps"]
    spec = dict(p["spec"], name="P2", events=str(tmp / "p2.events.jsonl"))
    with _Child(spec) as c:
        second = c.result()
    restore = _spans(spec["events"], "train.resume")
    out = {"run": "P", "preempted_after_steps": done,
           "first_outcome": first["outcome"],
           "committed_at_exit": p["committed"],
           "sigterm_to_return_s": p["sigterm_to_return_s"],
           "sigterm_to_exit_s": p["sigterm_to_exit_s"],
           "restore_latest_s": restore[0][2] / 1e3 if restore else None,
           "first_losses_bitwise": all(
               v == u["losses"][s] for s, v in first["losses"].items()),
           **_resumed_alike(second, u, done, "P", later),
           "wall_s": p["wall_s"] + time.perf_counter() - t0}
    later(out["first_losses_bitwise"], "P's first child's losses differ "
          "from U's")
    return out


def train_run_torn_first(tmp, base, later):
    """T and K in one child: the RUN_TORN_AT-th commit (step 16) torn
    after its marker lands, then the child SIGKILLed while the step-24
    file is renamed into place but not committed (its writer computes
    the sha256 for the marker).  fsck must name the torn file as an
    error and the uncommitted one as a warning."""
    from singa_tpu_torch.tools import ckpt_fsck
    from singa_tpu_torch.train import AsyncCheckpointManager
    t0 = time.perf_counter()
    spec = dict(base, name="TK1", dir=str(tmp / "t"),
                events=str(tmp / "tk1.events.jsonl"))
    env = {"SINGA_FAULTS": f"ckpt.torn=torn_write:at={RUN_TORN_AT}"}
    mgr = AsyncCheckpointManager(spec["dir"])
    torn = Path(mgr.path(RUN_CKPT["save_every"] * RUN_TORN_AT))
    npz = Path(mgr.path(RUN_STEPS))
    marker = Path(mgr.marker_path(RUN_STEPS))
    with _Child(spec, env) as c:
        c.wait_for(lambda o: o.get("step_done", 0) >= RUN_STEPS)
        deadline = time.perf_counter() + RUN_CHILD_TIMEOUT_S
        while not npz.exists() and not marker.exists() \
                and c.proc.poll() is None \
                and time.perf_counter() < deadline:
            time.sleep(0.002)
        c.proc.kill()
        c.proc.wait()
    caught = npz.exists() and not marker.exists()
    committed = mgr.steps()
    errors, warns = ckpt_fsck.fsck_dir(spec["dir"])
    rc = ckpt_fsck.main([spec["dir"]])
    later(committed == [RUN_CKPT["save_every"],
                        RUN_CKPT["save_every"] * RUN_TORN_AT]
          and len(errors) == 1 and torn.name in errors[0] and rc == 1,
          f"T: commits {committed}, fsck gave {errors} (rc {rc}), not one "
          f"error naming {torn.name}")
    later(caught and any(npz.name in w and "no commit marker" in w
                         for w in warns),
          f"K: the kill missed the window between the step-{RUN_STEPS} "
          f"rename and its marker, or fsck did not warn of it: {warns}")
    return {"spec": spec, "committed_at_kill": committed,
            "killed_between_rename_and_marker": caught,
            "fsck_errors": errors, "fsck_warnings": warns, "fsck_rc": rc,
            "wall_s": time.perf_counter() - t0}


def train_run_torn_resume(tmp, u, tk, later):
    """T and K, second child: skips the uncommitted step-24 file and
    the torn step-16 commit, restores step 8 and runs on to U's end."""
    t0 = time.perf_counter()
    spec = dict(tk["spec"], name="TK2", events=str(tmp / "tk2.events.jsonl"))
    with _Child(spec) as c:
        second = c.result()
    out = {"run": "T+K", **{k: v for k, v in tk.items()
                            if k not in ("spec", "wall_s")},
           **_resumed_alike(second, u, RUN_CKPT["save_every"], "T+K",
                            later),
           "wall_s": tk["wall_s"] + time.perf_counter() - t0}
    return out


def train_run_retried(tmp, store, u, later):
    """R, in this process: a train.step error at step index
    RUN_RETRY_STEP retried once, then the step at RUN_FAULT_STEP
    failing RUN_MAX_RETRIES + 1 times: an emergency checkpoint with the
    pre-draw cursor, an "aborted" record with its flight dump,
    TrainAborted because on_fatal returns; the losses up to the abort
    and a resume from its checkpoint match U."""
    from singa_tpu_torch import faults
    from singa_tpu_torch.obs import events
    from singa_tpu_torch.obs.record import RunRecord
    from singa_tpu_torch.train import (AsyncCheckpointManager, TrainAborted,
                                       TrainRunner)
    t0 = time.perf_counter()

    def run(ckpt, plan, **kw):
        m, loader = train_run_model()
        losses, sleeps = {}, []
        r = TrainRunner(m, loader, RUN_STEPS, ckpt=ckpt, record_store=store,
                        max_retries=RUN_MAX_RETRIES, _sleep=sleeps.append,
                        on_step=lambda s, o: losses.__setitem__(s, o[1]),
                        **kw)
        aborted = None
        with faults.active(plan), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                res = dataclasses.asdict(r.run())
            except TrainAborted as e:
                res, aborted = None, str(e)
            finally:
                r.__exit__()
        out = {"losses": {s: float(v) for s, v in losses.items()},
               "sleeps": sleeps, "aborted": aborted,
               "fired": plan.fire_count()}
        if res is not None:
            out.update(res, digest=run_digest(m))
        del m, loader, r
        _free()
        return out

    # the site counts attempts: the retry moves later steps' calls by one
    def call(step):
        return step + 1 + (step > RUN_RETRY_STEP)
    d = str(tmp / "r")
    ev = str(tmp / "r.events.jsonl")
    events.configure(path=ev)
    fatals = []
    specs = [faults.FaultSpec("train.step", "error", at=call(RUN_RETRY_STEP))]
    specs += [faults.FaultSpec("train.step", "error",
                               at=call(RUN_FAULT_STEP) + i)
              for i in range(RUN_MAX_RETRIES + 1)]
    aborted = run(AsyncCheckpointManager(d, **RUN_CKPT),
                  faults.FaultPlan(specs), on_fatal=fatals.append)
    events.configure()
    retries = _counters(ev, "train.retries")
    mgr = AsyncCheckpointManager(d)
    committed = mgr.steps()
    aux = _aux_of(mgr.path(RUN_FAULT_STEP)) \
        if RUN_FAULT_STEP in committed else {}
    cursor = aux.get("run_state", {}).get("data_state")
    entry = RunRecord(store).entries()[-1]
    ref = entry["payload"].get("flight_ref")
    before = {s: u["losses"][s] for s in range(RUN_FAULT_STEP)}
    resumed = run(AsyncCheckpointManager(d, **RUN_CKPT), faults.FaultPlan())
    out = {"run": "R", "retried_step": RUN_RETRY_STEP,
           "abort_step": RUN_FAULT_STEP, "fired": aborted["fired"],
           "train_retries_counters": retries, "backoff_s": aborted["sleeps"],
           "losses_to_abort_bitwise": aborted["losses"] == before,
           "train_aborted": aborted["aborted"], "on_fatal": fatals,
           "committed_at_abort": committed, "emergency_cursor": cursor,
           "record": entry["payload"],
           "flight_dump_exists": bool(ref) and (
               Path(store).parent / ref).exists(),
           **_resumed_alike(resumed, u, RUN_FAULT_STEP, "R", later),
           "wall_s": time.perf_counter() - t0}
    later(retries == 1 + RUN_MAX_RETRIES
          and aborted["fired"] == 2 + RUN_MAX_RETRIES
          and out["losses_to_abort_bitwise"],
          f"R: the retry at step {RUN_RETRY_STEP} left U's trajectory or "
          f"the faults did not fire as planned: {out}")
    later(aborted["aborted"] is not None and len(fatals) == 1,
          f"R: retries were not exhausted into TrainAborted: {out}")
    later(committed == [RUN_CKPT["save_every"], RUN_FAULT_STEP]
          and cursor is not None and cursor["epoch"] == 0
          and cursor["batch_idx"] == RUN_FAULT_STEP,
          f"R: the emergency checkpoint {committed} holds cursor {cursor}, "
          f"not the pre-draw {RUN_FAULT_STEP}")
    later(entry["payload"]["outcome"] == "aborted"
          and out["flight_dump_exists"], f"R: the record {entry} has no "
          f"flight dump")
    return out


def train_run_hung(tmp, base, later):
    """H: a child whose step at index RUN_HANG_STEP hangs RUN_HANG[1] s
    under step_timeout RUN_HANG[0] must exit 42 within step_timeout + 2
    s of the hang's start, leaving a "hung" record and a flight dump.
    Where that time went, on the wall clock from the hang's start: to
    the record's stamp (the watchdog's wait and the flight dump), to the
    store's rewrite (the record's lock and fsync), to the FATAL line on
    stderr, and to the exit."""
    from singa_tpu_torch.obs.record import RunRecord
    t0 = time.perf_counter()
    timeout, delay = RUN_HANG
    spec = dict(base, name="H", dir=None, events=str(tmp / "h.events.jsonl"),
                prewarm=True, step_timeout=timeout)
    env = {"SINGA_FAULTS": f"train.step=hang:at={RUN_HANG_STEP + 1},"
                           f"delay={delay}"}
    with _Child(spec, env) as c:
        t_hang, _ = c.wait_for(
            lambda o: o.get("step_done", 0) >= RUN_HANG_STEP)
        wall_hang = time.time() - (time.perf_counter() - t_hang)
        rc = c.proc.wait(timeout=RUN_CHILD_TIMEOUT_S)
        exit_s = time.perf_counter() - t_hang
    hung = [e for e in RunRecord(spec["store"]).entries()
            if e["payload"].get("outcome") == "hung"]
    ref = hung[-1]["payload"].get("flight_ref") if hung else None
    out = {"run": "H", "rc": rc, "hang_to_exit_s": exit_s,
           "limit_s": timeout + 2, "step_timeout": timeout,
           "hang_to_s": {
               "record_stamp": hung[-1]["created_at"] - wall_hang
               if hung else None,
               "store_written": os.path.getmtime(spec["store"]) - wall_hang,
               "fatal_line": os.path.getmtime(c.err_path) - wall_hang,
               "exit": exit_s},
           "record": hung[-1]["payload"] if hung else None,
           "flight_dump_exists": bool(ref) and (
               Path(spec["store"]).parent / ref).exists(),
           "wall_s": time.perf_counter() - t0}
    later(rc == 42 and exit_s <= timeout + 2, f"H: exit {rc} "
          f"{exit_s} s after the hang began (limit {timeout + 2} s)")
    later(len(hung) == 1 and out["flight_dump_exists"],
          f"H: {len(hung)} hung records, dump {ref}")
    return out


def _in_threads(*fns):
    """Each fn() on a thread of its own, all at once: their results in
    order; the first failure is raised once all have ended."""
    import threading
    results, errors = [None] * len(fns), []

    def run(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:       # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def phase_train_run(builder=RUN_BUILDER):
    """Fault-tolerant training runs of GPT-2 124M through
    singa_tpu_torch.train: U uninterrupted, alone in this process; then
    a child H (hung) alone; then two children at once: P (preempted)
    and T+K (a commit torn, then killed mid-write); then P's and T+K's
    resumes at once, beside R (a retried step, then retries exhausted, and its resume)
    in this process.  Each resumed run held to U bitwise in losses and
    final state."""
    import shutil
    from singa_tpu_torch.obs.record import RunRecord
    t0 = time.perf_counter()
    card = smi_line()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))

    def show(res):
        emit({"phase": "train_run", "card": card, **res})
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_run_"))
    store = str(tmp / "records.jsonl")
    base = {"builder": builder, "store": store}
    try:
        u, tools = train_run_u(tmp, store, later)
        show({"config": f"GPT2Config() (GPT-2 124M) cut to {RUN_LAYERS} "
                        f"layers, fused_loss, dropout 0.1, AdamW", **u})
        show({"run": "tools", **tools})
        # H alone: its exit time is the watchdog's, not the fsyncs of
        # P's and T+K's checkpoint writes
        show(train_run_hung(tmp, base, later))
        p, tk = _in_threads(
            lambda: train_run_preempt_first(tmp, base, later),
            lambda: train_run_torn_first(tmp, base, later))
        p, tk, r = _in_threads(
            lambda: train_run_preempt_resume(tmp, u, p, later),
            lambda: train_run_torn_resume(tmp, u, tk, later),
            lambda: train_run_retried(tmp, store, u, later))
        for res in (p, tk, r):
            show(res)
        problems = RunRecord(store).validate()
        later(not problems, f"the run records do not validate: {problems}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    show({"records_valid": not problems,
          "failed": [msg for ok, msg in checks if not ok],
          "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return u["flash_launches"]

def _rel_err(got, want):
    """max |got - want| over max |want|, in f32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _round_trip(native, inputs, later, what,
                expect=("LayerNormalization", "Gelu")):
    """`native` exported by the port at `inputs`, serialised, parsed back
    and checked, each op of `expect` a node of its own: the parsed proto
    and the codec's figures."""
    from singa_tpu_torch import sonnx
    t = time.perf_counter()
    p = sonnx.to_onnx(native, inputs)
    t_export = time.perf_counter() - t
    t = time.perf_counter()
    data = p.SerializeToString()
    t_ser = time.perf_counter() - t
    del p
    t = time.perf_counter()
    parsed = sonnx.load_model_from_string(data)
    t_parse = time.perf_counter() - t
    sonnx.check_model(parsed)
    ops = {}
    for n in parsed.graph.node:
        ops[n.op_type] = ops.get(n.op_type, 0) + 1
    later(all(ops.get(op) for op in expect),
          f"{what}'s export lacks single {' / '.join(expect)} nodes: {ops}")
    return parsed, {"bytes": len(data), "export_s": t_export,
                    "serialize_s": t_ser, "parse_s": t_parse,
                    "nodes": len(parsed.graph.node),
                    "initializers": len(parsed.graph.initializer),
                    "ops": ops}


def _logit_checks(native, rep, args, later, what, plant=None):
    """An import's eval logits against its native model's on the card,
    both eager, on the export's inputs: in bf16 (LOGIT_RTOL of the
    largest) and in f32, TF32 off (SONNX_F32_LOGIT); with `plant` (a
    thunk making a faulty import), the same f32 comparison must exceed
    the limit."""
    dev = native.device
    native.eval()
    rep.eval()
    res = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            saved, dev.default_dtype = dev.default_dtype, dtype
            try:
                want = native(*args)
                got = rep(*args)
                key = "bf16" if dtype == torch.bfloat16 else "f32"
                res[key] = {"max_rel_to_largest": _rel_err(got, want),
                            "limit": LOGIT_RTOL if key == "bf16"
                            else SONNX_F32_LOGIT,
                            "dtype": str(got.dtype),
                            "finite": bool(torch.isfinite(got).all())}
                if plant is not None and key == "f32":
                    bad = plant()
                    bad.eval()
                    res["planted"] = {"initializer": SONNX_PLANT,
                                      "scale": SONNX_PLANT_SCALE,
                                      "max_rel_to_largest":
                                      _rel_err(bad(*args), want)}
                    del bad
            finally:
                dev.default_dtype = saved
    res["shape"] = list(got.shape)
    for key in ("bf16", "f32"):
        r = res[key]
        later(r["finite"] and r["max_rel_to_largest"] <= r["limit"],
              f"{what}'s import differs from the native model in {key}: "
              f"{r}")
    if plant is not None:
        later(res["planted"]["max_rel_to_largest"] > SONNX_F32_LOGIT,
              f"{what}'s planted fault passes the f32 logit limit: "
              f"{res['planted']}")
    return res


def _planted(parsed, device):
    """A thunk importing `parsed` with its SONNX_PLANT initializer scaled
    by SONNX_PLANT_SCALE (the proto itself left as it was)."""
    from singa_tpu_torch import sonnx

    def make():
        init = next(t for t in parsed.graph.initializer
                    if t.name == SONNX_PLANT)
        raw = init.raw_data
        init.raw_data = sonnx.from_array(
            sonnx.to_array(init) * SONNX_PLANT_SCALE).raw_data
        try:
            return sonnx.prepare(parsed, device=device)
        finally:
            init.raw_data = raw
    return make


def sonnx_gpt2(later):
    """GPT-2 124M exported and imported for inference: logits against
    the native forward, a captured eval against an eager one (bitwise)
    and their times, no flash launch."""
    from singa_tpu_torch import sonnx
    from singa_tpu_torch.models import GPT2Config
    from singa_tpu_torch.ops import flash_attention as fa

    cfg = GPT2Config()
    native = gpt2_model(cfg)
    b, t = SONNX_GPT2
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, t)).astype(np.int32), device="cuda")
    parsed, codec = _round_trip(native, [ids], later, "GPT-2")
    # the tied head: one initializer that the embedding and the head read
    codec["wte_initializers"] = sum(
        t.name == "wte.table" for t in parsed.graph.initializer)
    codec["wte_readers"] = [n.op_type for n in parsed.graph.node
                            if "wte.table" in n.input]
    later(codec["wte_initializers"] == 1 and len(codec["wte_readers"]) == 2,
          f"GPT-2's tied head is not one shared initializer: {codec}")
    t0 = time.perf_counter()
    rep = sonnx.prepare(parsed, device=native.device)
    prepare_s = time.perf_counter() - t0
    logits = _logit_checks(native, rep, [ids], later, "GPT-2")
    del native, parsed
    _free()
    params = sum(p.numel() for p in rep.get_params().values())
    fa.reset_device_launches()
    with torch.no_grad():
        rep.graph_mode = False
        eager = rep(ids)
        rep.compile([ids], is_train=False, use_graph=True)
        outs = [rep(ids) for _ in range(3)]
        rep.graph_mode = False
        eager_ms = _median_ms(lambda: rep(ids))
        rep.graph_mode = True
        graph_ms = _median_ms(lambda: rep(ids), SONNX_EVAL_CALLS)
    launches = fa.device_launches()
    calls = 4 + 5 + SONNX_EVAL_CALLS
    g = rep.get_graph("eval")
    res = {"config": "GPT2Config() (GPT-2 124M)", "B": b, "T": t,
           "params": params, "codec": codec, "prepare_s": prepare_s,
           "logits": logits,
           "captured": g is not None and g.graph is not None,
           "captured_equals_eager": all(torch.equal(o, eager) for o in outs),
           "eager_ms": eager_ms, "captured_ms": graph_ms,
           "tokens_per_s": b * t / (graph_ms / 1e3),
           "eager_tokens_per_s": b * t / (eager_ms / 1e3),
           "flash_launches": launches, "calls_counted": calls}
    later(res["captured"] and res["captured_equals_eager"],
          "GPT-2's imported captured eval differs from the eager one")
    later(params == 124_439_808, f"GPT-2's import has {params} parameters")
    later(not any(launches.values()), f"flash kernels ran on GPT-2's "
          f"import: {launches}")
    del rep, eager, outs
    _free()
    return res


def phase_sonnx(native_bert):
    """BERT-base through the ONNX path at bench.py's cell: exported by
    the port, serialised and parsed back, imported (sonnx.prepare) on the
    card and trained through compile/train_step, beside the native BERT
    step that the transformer phase measured (`native_bert`); its logits
    against the native model's; a profile of one replay; then GPT-2 124M
    imported for inference.  No flash launch on either path: an imported
    attention is MatMul / Softmax."""
    from singa_tpu_torch import autograd, device, sonnx
    from singa_tpu_torch.models import BERT, BERTConfig
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    bcfg = BERTConfig(num_labels=2)
    dev = device.create_device("cuda")
    native = BERT(bcfg, device=dev,
                  generator=torch.Generator("cuda").manual_seed(0))
    bb, bt = BERT_TRAIN
    ids, labels = _bert_batch(np.random.RandomState(0), bcfg.vocab_size,
                              bb, bt)
    flops_per_token = native.flops_per_token(bt)
    parsed, codec = _round_trip(native, [ids], later, "BERT")
    t = time.perf_counter()
    rep = sonnx.prepare(parsed, device=dev)
    prepare_s = time.perf_counter() - t
    logits = _logit_checks(native, rep, [ids], later, "BERT",
                           _planted(parsed, dev))
    del native, parsed
    _free()
    params = sum(p.numel() for p in rep.get_params().values())
    rep.set_loss(autograd.softmax_cross_entropy)
    train = config_train(rep, bb, bt, later, 0, flops_per_token,
                         make_batch=_bert_batch, cfg=bcfg)
    train["profile"] = phase_profile(
        lambda: rep.train_step(ids, labels), f"one replayed train step of "
        f"the imported BERT-base, B={bb} T={bt}", dict.fromkeys(fa.KERNELS, 0))
    del rep
    _free()
    bert = {"config": "BERTConfig(num_labels=2) (BERT-base), exported and "
                      "re-imported", "params": params, "codec": codec,
            "prepare_s": prepare_s, "logits": logits, "train": train,
            "native_step": native_bert,
            "step_vs_native": train["median_step_ms"]
            / native_bert["median_step_ms"]}
    later(params == 109_483_778, f"BERT's import has {params} parameters")
    gpt2 = sonnx_gpt2(later)
    emit({"phase": "sonnx", "card": smi_line(), "bert": bert, "gpt2": gpt2,
          "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return {"bert_train": train["launches"],
            "gpt2_eval": gpt2["flash_launches"],
            "gpt2_calls": gpt2["calls_counted"]}


# -- phase rnn: the char-rnn ------------------------------------------------------

def phase_rnn():
    """The char-rnn (singa_tpu_torch.tools.train_rnn.CharRNN) at the
    reference example's widths (kernel_check.CHAR_RNN: two LSTMs of 128
    over an embedding of 64, batches of 64 x 64 characters, Adam 3e-3),
    weights from seed 0, bf16 activations over f32 masters:
    CHAR_RNN_STEPS steps eagerly and the same steps captured (a CUDA
    graph from the third), held bitwise in losses and parameters, the
    captured run's loss falling; chars/s of the replays; the trained
    model exported (two LSTM nodes), parsed back, imported on the card
    and its eval logits held to the native model's in bf16 and f32; then
    the trainer's command line at its defaults.  No flash launch on the
    path: the reference's lax.scan is plain torch here."""
    from singa_tpu_torch import device, kernel_check, opt, sonnx
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.tools import train_rnn

    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    dev = device.create_device("cuda")
    b, t = kernel_check.CHAR_RNN_BATCH
    n, w = kernel_check.CHAR_RNN_STEPS, kernel_check.CHAR_RNN_WINDOW
    chars = sorted(set(train_rnn.CORPUS))
    data = np.asarray([chars.index(c) for c in train_rnn.CORPUS], np.int32)
    rng = np.random.RandomState(0)
    batches = [tuple(torch.as_tensor(a, device="cuda")
                     for a in train_rnn.batches(data, b, t, rng))
               for _ in range(n)]
    fa.reset_device_launches()
    runs = {}
    for use_graph in (False, True):
        m = train_rnn.CharRNN(len(chars), device=dev,
                              generator=torch.Generator("cuda").manual_seed(0),
                              **kernel_check.CHAR_RNN)
        m.set_optimizer(opt.Adam(lr=kernel_check.CHAR_RNN_LR))
        m.compile([batches[0][0]], is_train=True, use_graph=use_graph)
        losses, times = [], []
        for x, y in batches:
            (_, loss), dt = _timed(lambda: m.train_step(x, y))
            losses.append(loss.item())
            times.append(dt)
        runs[use_graph] = (losses, times, {
            k: p.detach().clone() for k, p in m.get_params().items()})
    launches = fa.device_launches()
    losses, times, end = runs[True]
    differ = [k for k, p in runs[False][2].items()
              if not torch.equal(p, end[k])]
    g = m.get_graph("train")
    replay_ms = sorted(times[3:])[len(times[3:]) // 2] * 1e3
    params = sum(p.numel() for p in m.get_params().values())
    train = {"B": b, "T": t, "vocab": len(chars), "params": params,
             "optimizer": "Adam(lr=3e-3)", "steps": n,
             "captured": g.graph is not None, "graph_num_ops": g.num_ops,
             "graph_pool_bytes": g.pool_bytes, "losses": losses,
             "eager_losses": runs[False][0],
             "eager_step_ms_median": sorted(runs[False][1])[n // 2] * 1e3,
             "bitwise": runs[False][0] == losses and not differ,
             "params_differing": differ[:8],
             "loss_first": float(np.mean(losses[:w])),
             "loss_last": float(np.mean(losses[-w:])),
             "replay_step_ms": [x * 1e3 for x in times[3:]],
             "median_step_ms": replay_ms,
             "chars_per_s": b * t / (replay_ms / 1e3),
             "flash_launches": launches}
    del runs
    later(train["captured"] and train["bitwise"],
          f"the char-rnn's captured steps differ from eager: "
          f"{differ[:8]}, losses {losses} vs {train['eager_losses']}")
    later(all(np.isfinite(losses))
          and train["loss_last"] < train["loss_first"],
          f"the char-rnn's loss did not fall: {losses}")
    later(not any(launches.values()), f"flash kernels ran on the "
          f"char-rnn's path: {launches}")
    m.graph_mode = False
    x = batches[0][0]
    parsed, codec = _round_trip(m, [x], later, "char-rnn", expect=("LSTM",))
    later(codec["ops"].get("LSTM") == kernel_check.CHAR_RNN["num_layers"],
          f"the char-rnn's export holds {codec['ops'].get('LSTM')} LSTM "
          f"nodes")
    rep = sonnx.prepare(parsed, device=dev)
    logits = _logit_checks(m, rep, [x], later, "the char-rnn")
    del m, rep, parsed, batches
    _free()
    fa.reset_device_launches()
    printed = io.StringIO()
    with redirect_stdout(printed):
        cli = train_rnn.main([])
    cli_launches = fa.device_launches()
    cli = {k: v for k, v in cli.items() if k != "losses"} | {
        "loss_first": cli["losses"][0], "loss_last": cli["losses"][-1],
        "flash_launches": cli_launches,
        "printed": printed.getvalue().splitlines()[-14:]}
    later(cli["train_captured"] and cli["loss_last"] < cli["loss_first"]
          and not any(cli_launches.values()),
          f"tools/train_rnn on the card: {cli}")
    _free()
    emit({"phase": "rnn", "card": smi_line(),
          "config": "CharRNN(hidden=128, embed=64, num_layers=2), "
                    "examples/rnn/train.py's defaults",
          "train": train, "onnx": {"codec": codec, "logits": logits},
          "cli": cli, "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return {k: launches[k] + cli_launches[k] for k in fa.KERNELS}


#: kernels that convert an activation between NCHW and NHWC
def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ring_residual(g, block=DIST_RING_BLOCK):
    """g − dequant(quant(g)) at a world of 1: blocks of `block` over the
    flattened, padded g, the scale absmax·f32(1/127), codes rounded
    half to even and clipped to ±127, the difference rounded once."""
    flat = g.float().reshape(-1)
    n = flat.numel()
    flat = torch.nn.functional.pad(flat, (0, (-n) % block))
    absmax = flat.reshape(-1, block).abs().amax(1)
    s = torch.where(absmax > 0, absmax * float(np.float32(1 / 127)),
                    torch.ones_like(absmax))
    grid = s.repeat_interleave(block)
    q = torch.clamp(torch.round(flat / grid), -127, 127)
    err = (flat.double() - q.double() * grid.double()).float()
    return err[:n].reshape(g.shape)


def dist_equals_base(m, batches):
    """From the same weights, DIST_EQUAL_STEPS eager steps with
    SGD(0.01, 0.9) and with DistOpt of it: losses and parameters
    bitwise (at a world of 1 the sync is an NCCL allreduce of one rank
    and a product with 1.0)."""
    from singa_tpu_torch import opt
    start = {n: p.detach().cpu() for n, p in m.get_params().items()}
    runs = {}
    for wrap in (False, True):
        m.set_params(start)
        base = opt.SGD(lr=0.01, momentum=0.9)
        m.set_optimizer(opt.DistOpt(base) if wrap else base)
        m.compile([batches[0]], is_train=True, use_graph=False)
        runs[wrap] = [m.train_step(b)[1].item() for b in batches]
        if not wrap:
            end = {n: p.detach().cpu() for n, p in m.get_params().items()}
    differ = [n for n, p in m.get_params().items()
              if not torch.equal(p.detach().cpu(), end[n])]
    m.set_params(start)
    return {"steps": len(batches), "base_losses": runs[False],
            "distopt_losses": runs[True],
            "bitwise": runs[False] == runs[True] and not differ,
            "params_differing": differ[:8]}


def dist_eager_step(m, mode, kw, x):
    """One eager DistOpt step (graph mode off: no executor records it)
    from the model's weights with a ledger installed (obs.attr): its
    grad_sync milliseconds beside the step's; under int8_ring also the
    residual of DIST_RESIDUAL_PARAM against `ring_residual` of the
    step's own gradient."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.obs import attr
    out = {}
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.01, momentum=0.9), **kw))
    m.compile([x], is_train=True, use_graph=False)
    if mode == "int8_ring":
        g = _loss_and_grads(m, x, names=(DIST_RESIDUAL_PARAM,))[1][
            DIST_RESIDUAL_PARAM]
    led = attr.install()
    try:
        out["train_step_ms"] = _timed(lambda: m.train_step(x))[1] * 1e3
    finally:
        attr.uninstall()
    out["grad_sync_ms"] = led.snapshot()["grad_sync"]["total_s"] * 1e3
    if mode == "int8_ring":
        res = m.optimizer._eager_state[DIST_RESIDUAL_PARAM]["ef"][0]
        want = ring_residual(g)
        out["residual"] = {
            "param": DIST_RESIDUAL_PARAM, "bitwise": torch.equal(res, want),
            "max_abs": res.abs().max().item(),
            "max_abs_diff": (res - want).abs().max().item(),
            "nonzero_share": (res != 0).float().mean().item()}
    return out


def phase_dist():
    """Data-parallel training on the card: an NCCL group of 1 through
    parallel.init_distributed, the data mesh set, base()'s training cell
    through DistOpt in three sync modes, and ResNet-50 at phase cnn's
    cell through DistOpt and through tools/train_cnn --dist.  The group
    is destroyed at the end."""
    import os
    from singa_tpu_torch import device, models, opt, parallel
    from singa_tpu_torch.models import Llama, LlamaConfig
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.tools import train_cnn

    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host
    rank = parallel.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        parallel.set_mesh(parallel.data_parallel_mesh())
        group = {"rank": rank, "world": torch.distributed.get_world_size(),
                 "backend": torch.distributed.get_backend(),
                 "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
        later(group["backend"] == "nccl" and group["world"] == 1,
              f"the group is not NCCL at a world of 1: {group}")

        cfg = dataclasses.replace(LlamaConfig.base(), fused_loss=True,
                                  num_layers=DIST_LAYERS)
        m = Llama(cfg, device=device.create_device("cuda"),
                  generator=torch.Generator("cuda").manual_seed(0))
        init = {n: p.detach().cpu() for n, p in m.get_params().items()}
        rng = np.random.RandomState(3)
        batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (TB, TT))
                                   .astype(np.int32), device="cuda")
                   for _ in range(DIST_EQUAL_STEPS)]
        equal = dist_equals_base(m, batches)
        later(equal["bitwise"], f"the plain DistOpt step at a world of 1 is "
              f"not the base optimizer's step: {equal}")
        llama = {}
        for mode, kw in DIST_MODES.items():
            m.set_params(init)
            eager = dist_eager_step(m, mode, kw, batches[0])
            m.set_params(init)
            run = config_train(
                m, TB, TT, later, cfg.num_layers,
                flops_per_token=m.flops_per_token(TT),
                make_opt=lambda kw=kw: opt.DistOpt(
                    opt.SGD(lr=0.01, momentum=0.9), **kw))
            run.update(eager)
            llama[mode] = run
            if mode == "int8_ring":
                later(eager["residual"]["bitwise"],
                      f"the int8 ring's residual is not g - dequant(quant"
                      f"(g)): {eager['residual']}")
            m.compile([batches[0]], is_train=True, use_graph=False)
            _free()
        del m, init
        _free()

        fa.reset_device_launches()
        r50 = cnn_train("resnet50_dist", models.resnet50, (224, 224, 3),
                        1000, later, make_opt=lambda: opt.DistOpt(
                            opt.SGD(**CNN_SGD)))
        _free()
        t = time.perf_counter()
        cli = train_cnn.main(["--model", "resnet50", "--dataset", "imagenet",
                              "--batch-size", str(CNN_B), "--epochs", "1",
                              "--lr", "0.1", "--dist", "--log-every", "0"])
        ep = cli["epochs"][0]
        cli = {"world": cli["world"], "steps": cli["steps_per_epoch"],
               "losses": ep["losses"], "images_per_s": ep["images_per_s"],
               "test_acc": ep["test_acc"],
               "train_captured": cli["train_captured"],
               "eval_captured": cli["eval_captured"], "device": cli["device"],
               "seconds": time.perf_counter() - t}
        cnn_launches = fa.device_launches()
        later(np.isfinite(cli["losses"]).all() and cli["world"] == 1
              and cli["train_captured"], f"train_cnn --dist: {cli}")
        later(not any(cnn_launches.values()), f"flash kernels ran on the "
              f"data-parallel ResNet-50 path: {cnn_launches}")
        _free()
    finally:
        parallel.finalize_distributed()
        _free()
    later(not torch.distributed.is_initialized()
          and parallel.current_mesh() is None,
          "the process group or the mesh outlived the phase")
    emit({"phase": "dist", "group": group, "llama_base": {
        "config": f"LlamaConfig.base(), fused_loss=True, {DIST_LAYERS} "
                  f"layers", "B": TB, "T": TT,
        "distopt_vs_base": equal, "modes": llama,
        "beside_phase_train": SUMMARY.get("train")},
        "resnet50": r50, "resnet50_beside_phase_cnn": SUMMARY.get("cnn"),
        "train_cnn_dist": cli, "resnet50_flash_launches": cnn_launches,
        "allreduce_bandwidth": "not measured: a world of 1 moves no bytes "
                               "between cards",
        "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return ({mode: {k: run["launches"][k] for k in fa.KERNELS}
             for mode, run in llama.items()}, cnn_launches)


# phase spmd: base() training under the three-axis mesh at a world of 1
# (every Linear and embedding in its Megatron form, every collective
# over a group of one), SPMD_STEPS steps from the same weights against
# the plain step, then TRAIN_STEPS timed replays beside the plain step's
SPMD_STEPS = 5


def replay_ms(m, x, steps=TRAIN_STEPS):
    """`steps` train_step calls of a captured model on batch `x`: their
    median ms and each kernel's launches on the card per step."""
    from singa_tpu_torch.ops import flash_attention as fa
    times, per_step = [], []
    for _ in range(steps):
        before = fa.device_launches()
        times.append(_timed(lambda: m.train_step(x))[1])
        after = fa.device_launches()
        per_step.append({k: after[k] - before[k] for k in fa.KERNELS})
    return sorted(times)[len(times) // 2] * 1e3, per_step


def ring_block_ms(S, dtype=torch.bfloat16):
    """Kernel ms of the last rank's blocks of a causal ring of S at
    RING_SHAPE (its diagonal causal and S − 1 full blocks of T/S: the
    most a rank makes), forward and the two backward kernels, beside one
    whole-sequence call of each at the same shape."""
    from singa_tpu_torch import kernel_check
    from singa_tpu_torch.ops import flash_attention as fa
    q, k, v, do = kernel_check.ring_inputs("timing", dtype)
    T = q.shape[1]
    Tl = T // S
    scale = q.shape[-1] ** -0.5
    qi = q[:, T - Tl:].contiguous()
    doi = do[:, T - Tl:].contiguous()
    blocks = [(k[:, j * Tl:(j + 1) * Tl].contiguous(),
               v[:, j * Tl:(j + 1) * Tl].contiguous(), j == S - 1)
              for j in range(S)]

    def bwd_args(q_, k_, v_, do_, causal):
        o, lse = fa._flash_fwd_cuda(q_, k_, v_, causal, scale)
        delta = (do_.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
        return (q_, k_, v_, do_, lse, delta.contiguous(), causal, scale)
    rank_args = [bwd_args(qi, kb, vb, doi, c) for kb, vb, c in blocks]
    whole_args = bwd_args(q, k, v, do, True)

    def fwd_rank():
        for kb, vb, c in blocks:
            fa._flash_fwd_cuda(qi, kb, vb, c, scale)

    def bwd_rank():
        for a in rank_args:
            fa._launch_dq(*a)
            fa._launch_dkv(*a)
    return {"S": S, "T_local": Tl, "rank": S - 1, "blocks": S,
            "fwd_rank_ms": graph_time_ms(fwd_rank),
            "fwd_whole_ms": graph_time_ms(
                lambda: fa._flash_fwd_cuda(q, k, v, True, scale)),
            "bwd_rank_ms": graph_time_ms(bwd_rank),
            "bwd_whole_ms": graph_time_ms(
                lambda: (fa._launch_dq(*whole_args),
                         fa._launch_dkv(*whole_args)))}


def phase_spmd():
    """Tensor and sequence parallelism on the card, in an NCCL group of
    1: (a) LlamaConfig.base() with the fused loss trains through
    DistOpt(SGD) at phase train's cell under make_mesh(SPMD_AXES), its
    step captured, held bitwise against the plain step from the same
    weights and timed beside it; (b) ring attention's per-rank body
    (kernel_check.RING_CASES) over the shards of one card with an
    in-process hop, against the plain whole-sequence attention, its
    flash launches counted, each planted ring fault caught, and the
    kernel ms of one rank's blocks beside a whole-sequence call."""
    import os
    from singa_tpu_torch import device, kernel_check, opt, parallel
    from singa_tpu_torch.models import Llama, LlamaConfig
    from singa_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host
    parallel.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        cfg = dataclasses.replace(LlamaConfig.base(), fused_loss=True)
        m = Llama(cfg, device=device.create_device("cuda"),
                  generator=torch.Generator("cuda").manual_seed(0))
        rng = np.random.RandomState(11)
        batches = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (TB, TT))
                                   .astype(np.int32), device="cuda")
                   for _ in range(SPMD_STEPS)]
        make_opt = lambda: opt.SGD(lr=0.01, momentum=0.9)   # noqa: E731
        # the plain step's replays, timed on this model before the
        # multi-axis run cuts it (at a world of 1 the blocks are whole)
        start = {n: p.detach().cpu() for n, p in m.get_params().items()}
        m.set_optimizer(make_opt())
        m.compile([batches[0]], is_train=True, use_graph=True)
        for b in batches[:3]:
            m.train_step(b)
        plain_ms, _ = replay_ms(m, batches[0])
        m.set_params(start)
        del start
        same = kernel_check.spmd_vs_plain(m, batches, make_opt)
        parallel.set_mesh(None)
        spmd_ms, per_step = replay_ms(m, batches[0])
        forms = same["forms"]
        later(same["bitwise"], f"the three-axis step is not the plain "
              f"step bitwise: {same}")
        later(same["gspmd"] and same["captured"],
              f"the three-axis step did not take the multi-axis path "
              f"captured: {same}")
        later(forms["whole"] == 0 and forms["embedding"] == 1
              and forms["column"] == 5 * cfg.num_layers + 1
              and forms["row"] == 2 * cfg.num_layers,
              f"layers not in their Megatron forms: {forms}")
        later(all(s == dict.fromkeys(fa.KERNELS, cfg.num_layers)
                  for s in per_step),
              f"flash launches per three-axis step {per_step}, expected "
              f"{cfg.num_layers} of each")
        train = {"config": "LlamaConfig.base(), fused_loss=True",
                 "B": TB, "T": TT, "axes": kernel_check.SPMD_AXES,
                 "vs_plain": same, "median_step_ms": spmd_ms,
                 "plain_median_step_ms": plain_ms,
                 "phase_train": SUMMARY.get("train"),
                 "launches_per_step": per_step}
        del m
        _free()
    finally:
        parallel.finalize_distributed()
        _free()

    # (b) the ring's per-rank body at base()'s attention shape
    ring, ring_launches = [], {}
    for label in kernel_check.RING_CASES:
        for dtype in kernel_check.RING_DTYPES:
            r = kernel_check.check_ring(label, dtype)
            r.update(case=label, dtype=str(dtype)[6:])
            ring.append(r)
            ring_launches[f"{label}/{r['dtype']}"] = r["launches"]
            _free()
    bad = [f"{r['case']}/{r['dtype']}" for r in ring if not r["ok"]]
    later(not bad, f"ring cases disagree with the whole-sequence "
          f"attention: {bad}")
    bad = [f"{r['case']}/{r['dtype']}" for r in ring if not r["launches_ok"]]
    later(not bad, f"ring cases launched other counts than "
          f"ring_launches: {bad}")
    faulty = {}
    for name, (label, dtype, _) in kernel_check.RING_FAULTS.items():
        S, causal = kernel_check.RING_CASES[label]
        with kernel_check.ring_fault(name):
            faulty[name] = {"case": label, "dtype": str(dtype)[6:],
                            **kernel_check.ring_errors(
                                *kernel_check.ring_inputs(label, dtype),
                                S, causal, dtype)}
        later(not faulty[name]["ok"], f"planted ring fault {name} passes "
              f"the limits: {faulty[name]}")
        _free()
    timing = [ring_block_ms(S) for S in (2, 4)]
    _free()
    emit({"phase": "spmd", "nvidia_smi": smi_line(), "train": train,
          "ring_shape": dict(zip("BTHKD", kernel_check.RING_SHAPE)),
          "ring": ring, "ring_faults": faulty, "ring_block_ms": timing,
          "p2p_under_capture": "not run: a world of 1 makes no hop",
          "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return {"base_train": {"steps": TRAIN_STEPS,
                           "per_step": per_step[0]},
            "ring": ring_launches}


# phase pipe: pipeline and expert parallelism on one card
PIPE_TIMED = "s4_m8"             # the schedule timed beside the blocks in order
PLAN_GRAD_MARGIN = 0.0           # gradient bytes: the plan's against p.grad's


def pipe_schedule(later):
    """(a) base()'s blocks through kernel_check.PIPE_CASES in each dtype
    against the blocks in order, launches counted, faults planted in
    bf16, and the schedule's ms beside the sequential pass's."""
    from singa_tpu_torch import autograd, kernel_check as kc
    from singa_tpu_torch.ops import flash_attention as fa
    cases, launches, faulty, timing = [], {}, {}, {}
    autograd.set_training(True)
    try:
        for dtype in kc.PIPE_DTYPES:
            dt = str(dtype)[6:]
            blocks, x, do = kc.pipe_blocks(dtype)
            before = fa.device_launches()
            want = kc.seq_run(blocks, x, do)
            torch.cuda.synchronize()
            after = fa.device_launches()
            seq = {n: after[n] - before[n] for n in fa.KERNELS}
            later(all(v == len(blocks) for v in seq.values()),
                  f"sequential blocks launched {seq}, expected "
                  f"{len(blocks)} of each")
            for label in kc.PIPE_CASES:
                r = kc.check_pipe(label, dtype, blocks, x, do, want)
                r.update(case=label, dtype=dt)
                cases.append(r)
                launches[f"{label}/{dt}"] = r["launches"]
                later(r["ok"], f"pipe case {label}/{dt} disagrees with the "
                      f"blocks in order: {r}")
                later(r["launches_ok"], f"pipe case {label}/{dt} launched "
                      f"{r['launches']}, expected {r['expected_launches']}")
            if dtype == torch.bfloat16:
                for name, (label, fdt, _) in kc.PIPE_FAULTS.items():
                    S, M = kc.PIPE_CASES[label]
                    with kc.pipe_fault(name):
                        f = kc.pipe_errors(kc.pipe_run(blocks, x, do, S, M),
                                           want, fdt)
                    faulty[name] = {"case": label, "dtype": dt, **f}
                    later(not f["ok"], f"planted pipe fault {name} passes "
                          f"the limits: {f}")
                S, M = kc.PIPE_CASES[PIPE_TIMED]
                timing = {
                    "case": PIPE_TIMED, "dtype": dt,
                    "schedule_ms": cuda_time_ms(
                        lambda: kc.pipe_run(blocks, x, do, S, M), iters=5,
                        warmup=1),
                    "sequential_ms": cuda_time_ms(
                        lambda: kc.seq_run(blocks, x, do), iters=5,
                        warmup=1),
                    "timed_by": "CUDA events over 5 eager forward and "
                                "backward passes, S in-process stages "
                                "one after another on one card"}
            del blocks, x, do, want
            _free()
    finally:
        autograd.set_training(False)
    return cases, launches, faulty, timing


def _held(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def pipe_planner(later):
    """(b) base() planned under SGD(momentum) at a world of 1 against
    what its model and optimizer hold after one captured step;
    llama3_8b's plan on data 4 x model 8."""
    from singa_tpu_torch import device, opt
    from singa_tpu_torch.models import Llama, LlamaConfig
    from singa_tpu_torch.parallel import planner
    cfg = dataclasses.replace(LlamaConfig.base(), fused_loss=True)
    make_opt = lambda: opt.SGD(lr=0.01, momentum=0.9)   # noqa: E731
    t = time.perf_counter()
    plan = planner.plan_train_step(
        lambda d: Llama(cfg, device=d), make_opt(),
        ((torch.Size([TB, TT]), torch.int32),), {"data": 1}, lower=True)
    plan_s = time.perf_counter() - t
    m = Llama(cfg, device=device.create_device("cuda"),
              generator=torch.Generator("cuda").manual_seed(0))
    x = torch.as_tensor(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (TB, TT)).astype(np.int32), device="cuda")
    m.set_optimizer(make_opt())
    m.compile([x], is_train=True, use_graph=True)
    for _ in range(3):                       # the third call is captured
        m.train_step(x)
    torch.cuda.synchronize()
    params = m.get_params()
    held = {"param_bytes": _held(params.values()),
            "slot_bytes": _held(t for ls in m.optimizer.slot_arrays()
                                .values() for t in ls),
            "grad_bytes": _held(p.grad for p in params.values()
                                if p.grad is not None),
            "captured": m.graph is not None and m.graph.graph is not None,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    planned = {"param_bytes": plan.param_bytes_per_device,
               "slot_bytes": plan.slot_bytes_per_device,
               "grad_bytes": plan.grad_bytes_per_device,
               "state_bytes": plan.per_device_state_bytes,
               "lowered_ops": plan.lowered.num_ops,
               "lowered_flops": plan.lowered.flops(), "seconds": plan_s}
    later(held["captured"], "the planner's check step was not captured")
    for k in ("param_bytes", "slot_bytes"):
        later(planned[k] == held[k], f"planned {k} {planned[k]} != held "
              f"{held[k]}")
    gap = abs(planned["grad_bytes"] - held["grad_bytes"]) / held["grad_bytes"]
    later(gap <= PLAN_GRAD_MARGIN, f"planned gradient bytes "
          f"{planned['grad_bytes']} differ from p.grad's {held['grad_bytes']} "
          f"by {gap:.4f} > {PLAN_GRAD_MARGIN}")
    del m, x
    _free()
    big = planner.plan_train_step(
        lambda d: Llama(LlamaConfig.llama3_8b(), device=d),
        opt.SGD(lr=1e-3, momentum=0.9), ((torch.Size([4, 1024]), torch.int32),),
        {"data": 4, "model": 8}, lower=False)
    total = torch.cuda.get_device_properties(0).total_memory
    later(planner.HBM_BYTES["h100"] == total, f"HBM_BYTES['h100'] "
          f"{planner.HBM_BYTES['h100']} is not this card's total_memory "
          f"{total}")
    return {"base_world_1": {"planned": planned, "held": held,
                             "grad_margin": PLAN_GRAD_MARGIN},
            "llama3_8b_data4_model8": {
                "param_bytes_global": big.param_bytes_global,
                "param_bytes_per_device": big.param_bytes_per_device,
                "slot_bytes_per_device": big.slot_bytes_per_device,
                "state_bytes_per_device": big.per_device_state_bytes,
                "fits_h100": big.fits("h100")},
            "total_memory": total, "device_name": torch.cuda.get_device_name(0)}


def pipe_experts(later):
    """(c) mixtral-8x7b's MoE layer over ep in-process expert ranks
    against the one-device scatter path (kernel_check.EP_CASES)."""
    from singa_tpu_torch import kernel_check as kc
    from singa_tpu_torch.ops import moe
    from singa_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.set_mesh(mesh_mod.Mesh({"expert": 2}))
    try:
        auto = moe.resolve_dispatch("auto")
    finally:
        mesh_mod.set_mesh(None)
    later(auto == "einsum" and moe.resolve_dispatch("auto") == "scatter",
          f"'auto' resolves to {auto} under an expert axis")
    out = []
    for dtype in kc.EP_DTYPES:
        inputs = kc.ep_inputs(dtype)
        want = kc.ep_run(*inputs, 0)
        for label, ep in kc.EP_CASES.items():
            t = time.perf_counter()
            e = kc.ep_errors(kc.ep_run(*inputs, ep), want, dtype)
            e.update(case=label, dtype=str(dtype)[6:],
                     seconds=time.perf_counter() - t)
            out.append(e)
            later(e["ok"], f"expert case {label}/{e['dtype']} disagrees "
                  f"with the one-device scatter path: {e}")
        del inputs, want
        _free()
    return out


def phase_pipe():
    """Pipeline and expert parallelism on the card, whose one card runs
    no pipe or expert axis above 1: (a) LlamaConfig.base()'s 16 blocks
    through the per-rank GPipe body of S = 2 and 4 stages over M = S and
    2S microbatches with an in-process hop, in bf16 and f32, against the
    blocks in order, its flash launches counted, each planted pipe fault
    caught, and the schedule timed beside the blocks in order; (b) the
    planner against the bytes a trained base() holds; (c) Mixtral-8x7B's
    MoE layer over 2 and 4 in-process expert ranks against the one-device
    scatter path."""
    from singa_tpu_torch import kernel_check as kc
    t0 = time.perf_counter()
    checks = []

    def later(cond, msg):
        checks.append((bool(cond), msg))
    cases, launches, faulty, timing = pipe_schedule(later)
    _free()
    plan = pipe_planner(later)
    _free()
    experts = pipe_experts(later)
    _free()
    emit({"phase": "pipe", "nvidia_smi": smi_line(),
          "pipe_shape": {"config": "LlamaConfig.base() blocks",
                         "B": kc.PIPE_SHAPE[0], "T": kc.PIPE_SHAPE[1]},
          "cases": cases, "faults": faulty, "timing": timing,
          "planner": plan, "experts": experts,
          "p2p_under_capture": "not run: a world of 1 makes no hop",
          "phase_seconds": time.perf_counter() - t0})
    for cond, msg in checks:
        check(cond, msg)
    return launches


LAYOUT_KERNELS = ("nchwtonhwc", "nhwctonchw", "transpose")


def _kernel_kind(name):
    low = name.lower()
    for kind in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if kind + "_" in low:
            return kind
    if any(s in low for s in LAYOUT_KERNELS):
        return "layout_transpose"
    # cuDNN's implicit-GEMM convolutions are xmma kernels too
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "xmma", "gemv")):
        return "matmul"
    if "copy" in low:
        return "copy_or_cast"
    return "other"



def _profiled(fn, warmup=PROFILE_WARMUP):
    """fn() under torch.profiler with CPU and CUDA activities: (the
    profile, fn's wall ms to the card's end).  `warmup` spin kernels run
    and finish under the profiler before fn starts: see PROFILE_WARMUP."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(warmup):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def _is_warmup(name):
    return "spin_kernel" in name


def phase_profile(fn, what, expect):
    """Where one call's time goes on the card: device time of every
    kernel under torch.profiler, by kind, against the wall time of the
    same (profiled) call, the host's idle share of the card, and each
    hand-written kernel's launches, which must be `expect`: as the
    kernels counted them on the card, and by name in the profile.  The
    warm-up's records are left out of all of it.  A profiler that
    records no device time reports "not measured" for the times and the
    names instead of failing the run."""
    from torch.autograd import DeviceType
    from singa_tpu_torch.ops import flash_attention as fa

    fa.reset_device_launches()
    prof, wall_ms = _profiled(fn)
    counted = fa.device_launches()
    counted = {k: counted[k] for k in expect}
    by_name, warm = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if _is_warmup(e.name):
            warm += 1
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    by_kind, count = {}, {}
    for name, (ms, n) in by_name.items():
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        count[kind] = count.get(kind, 0) + n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    seen = {k: count.get(k, 0) for k in expect}
    device_events = sum(n for _, n in by_name.values())
    emit({"phase": "profile", "what": what,
          "wall_ms_profiled": wall_ms, "device_events": device_events,
          "warmup_records": {"launched": PROFILE_WARMUP, "kept": warm},
          "device_busy_ms": busy_ms if busy_ms else "not measured",
          "device_busy_share": busy_ms / wall_ms if busy_ms
          else "not measured",
          "host_idle_ms": wall_ms - busy_ms if busy_ms else "not measured",
          "device_ms_by_kind": by_kind, "launches_by_kind": count,
          "kernels_by_name": seen,
          "kernels_counted_on_card": counted, "expected_kernels": expect,
          "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]}
                          for k, v in top]})
    check(counted == expect, f"the kernels counted {counted} launches in "
          f"{what}, expected {expect}")
    if busy_ms:
        check(seen == expect, f"the profile of {what} saw {seen} launches "
              f"of the hand-written kernels, expected {expect} "
              f"({device_events} device events in all)")
    return {"device_ms_by_kind": by_kind, "launches_by_kind": count,
            "device_busy_ms": busy_ms, "device_events": device_events}


def profile_drops(duration_s=PROFILE_PROBE_S):
    """How many device records torch.profiler loses as the process ages:
    GPT-2 124M's replayed train step (phase transformer's: the fused
    loss, SGD momentum 0.9, B, T = GPT2_TRAIN) profiled through
    `_profiled` with no warm-up and with PROFILE_WARMUP, one after the
    other, then PROFILE_GAP_S of unprofiled replays, for `duration_s`.
    A line for each profile: the process's age, the call's device
    records, how many fewer than the most any profile kept, the warm-up
    records kept, and the flash launches by name and as counted on the
    card.  Not part of the script's run: `python3 -c "import chip_smoke
    as c; c.profile_drops()"` on the card."""
    from torch.autograd import DeviceType
    from singa_tpu_torch import opt
    from singa_tpu_torch.models import GPT2Config
    from singa_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    b, t = GPT2_TRAIN
    m = gpt2_model(dataclasses.replace(GPT2Config(), fused_loss=True))
    m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9))
    (x,) = _token_batch(np.random.RandomState(0), m.cfg.vocab_size, b, t)
    m.compile([x], is_train=True, use_graph=True)
    for _ in range(3):          # eager, eager on a side stream, capture
        m.train_step(x)
    torch.cuda.synchronize()
    runs = []
    while time.perf_counter() - t0 < duration_s:
        for warmup in (0, PROFILE_WARMUP):
            fa.reset_device_launches()
            prof, _ = _profiled(lambda: m.train_step(x), warmup)
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            kinds = [_kernel_kind(n) for n in names if not _is_warmup(n)]
            runs.append({"age_s": time.perf_counter() - t0,
                         "warmup": warmup,
                         "device_events": len(kinds),
                         "warmup_kept": len(names) - len(kinds),
                         "flash_by_name": {k: kinds.count(k)
                                           for k in fa.KERNELS},
                         "flash_counted_on_card": fa.device_launches()})
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < PROFILE_GAP_S:
            m.train_step(x)
        torch.cuda.synchronize()
    most = max(r["device_events"] for r in runs)
    for r in runs:
        emit({"phase": "profile_drops", **r,
              "lost": most - r["device_events"]})
    return runs


def _bound(flops, nbytes):
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _library(timed):
    """A library yardstick's time, or None where this torch lacks it."""
    try:
        return timed()
    except (TypeError, RuntimeError) as e:    # no enable_gqa in torch
        print(f"library yardstick unavailable: {e}", file=sys.stderr)
        return None


def attention_timing_rows(shape, b, t, h, k, d, causal, backward):
    """The forward (and with `backward` the dQ and dK/dV kernels) at
    (B, T, H, K, D) in bf16, each beside its bound, its plain version
    and the PyTorch call computing the same function
    (scaled_dot_product_attention, its gradient), and held against its
    plain version on the inputs it is timed on."""
    import torch.nn.functional as F
    from singa_tpu_torch import kernel_check
    from singa_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16
    scale = 1.0 / d ** 0.5
    q, kk, v = kernel_check.make_qkv(b, t, t, h, k, d, dtype, seed=1)
    pairs = t * (t + 1) // 2 if causal else t * t     # (q, k) pairs
    t_bytes = q.numel() * q.element_size()    # one (B, T, H, D) tensor
    kv_bytes = kk.numel() * kk.element_size()
    row_bytes = b * h * t * 4                 # one (B, H, T) f32
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kk, v))
    gqa = dict(enable_gqa=True) if k != h else {}

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              **gqa)
    o, lse = fa._flash_fwd_cuda(q, kk, v, causal, scale)
    errs = kernel_check.flash_errors(
        o, lse, *fa._flash_fwd_reference(q, kk, v, causal, scale), dtype)

    def kernel():
        return fa._flash_fwd_cuda(q, kk, v, causal, scale)
    rows = [{
        "name": "flash_fwd", "shape": shape, "timed_by": "cuda_graph",
        "ms": graph_time_ms(kernel),
        "events_ms": cuda_time_ms(kernel),
        "host_us_per_call": host_time_us(kernel),
        "plain_ms": graph_time_ms(
            lambda: fa._flash_fwd_reference(q, kk, v, causal, scale),
            reps=2, replays=5),
        "library_ms": _library(lambda: graph_time_ms(sdpa)),
        "library_covers": ["flash_fwd"],
        "max_abs_err": errs["max_abs_do"], "ok": errs["ok"],
        **_bound(4 * b * h * d * pairs,
                 2 * t_bytes + 2 * kv_bytes + row_bytes)}]
    if backward:
        g = torch.Generator("cuda").manual_seed(2)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
        args = (q, kk, v, do, lse, delta.contiguous(), causal, scale)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                            **gqa)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(og, (qg, kg, vg), dot,
                                       retain_graph=True)
        lib_bwd = _library(lambda: cuda_time_ms(sdpa_bwd))
        # one SDPA backward computes dq, dk and dv: its time is both rows'
        both = ["flash_bwd_dq", "flash_bwd_dkv"]
        errs = kernel_check.flash_bwd_errors(
            (fa._launch_dq(*args), *fa._launch_dkv(*args)),
            fa._flash_bwd_reference(*args), dtype)

        def dq_kernel():
            return fa._launch_dq(*args)

        def dkv_kernel():
            return fa._launch_dkv(*args)
        rows.append({
            "name": "flash_bwd_dq", "shape": shape, "timed_by": "cuda_graph",
            "ms": graph_time_ms(dq_kernel),
            "events_ms": cuda_time_ms(dq_kernel),
            "host_us_per_call": host_time_us(dq_kernel),
            "plain_ms": cuda_time_ms(lambda: fa._bwd_dq_reference(*args),
                                     iters=10),
            "library_ms": lib_bwd, "library_covers": both,
            "max_abs_err": errs["max_abs_dq"], "ok": errs["ok"],
            **_bound(6 * b * h * d * pairs,
                     3 * t_bytes + 2 * kv_bytes + 2 * row_bytes)})
        rows.append({
            "name": "flash_bwd_dkv", "shape": shape, "timed_by": "cuda_graph",
            "ms": graph_time_ms(dkv_kernel),
            "events_ms": cuda_time_ms(dkv_kernel),
            "host_us_per_call": host_time_us(dkv_kernel),
            "plain_ms": cuda_time_ms(lambda: fa._bwd_dkv_reference(*args),
                                     iters=10),
            "library_ms": lib_bwd, "library_covers": both,
            "max_abs_err": max(errs["max_abs_dk"], errs["max_abs_dv"]),
            "ok": errs["ok"],
            **_bound(8 * b * h * d * pairs,
                     2 * t_bytes + 4 * kv_bytes + 2 * row_bytes)})
    for r in rows:
        r["dims"] = [b, t, h, k, d]
        r["causal"] = causal
    return rows


def phase_timing():
    """Each kernel, its plain version and the PyTorch call computing the
    same function (a yardstick the port never calls), beside the card's
    bound, at base()'s training shape and GPT-2's; the forward also at
    base()'s prefill shape and at BERT-base's (B=256, T=128, not causal:
    a shape the route sends to the plain path, timed for the next
    decision on it); then mistral-w4096's window.  Each kernel is also
    held against its plain version on the inputs it is timed on."""
    rows = []
    for shape, b, t, h, k, d, causal, backward in (
            ("prefill", B, P, 16, 8, 128, True, False),
            ("train", TB, P, 16, 8, 128, True, True),
            ("gpt2_train", *GPT2_TRAIN, 12, 12, 64, True, True),
            ("bert", *BERT_TRAIN, 12, 12, 64, False, False)):
        rows += attention_timing_rows(shape, b, t, h, k, d, causal, backward)
    rows += window_timing_rows(_library)
    for r in rows:
        r.setdefault("causal", True)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        emit({"phase": "timing", "dtype": "bfloat16", **r})
    bad = [f"{r['name']}:{r['shape']}" for r in rows if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions on the "
          f"timed inputs: {bad}")
    return rows


def window_timing_rows(library):
    """The three kernels at mistral-w4096's attention shape (B=1, H=32,
    K=8, D=128, T=8192, W=4096, bf16) beside their bound, counting only
    the in-band (q, k) pairs; the plain versions run eight query heads
    (two kv heads) at a time, which is the same function at a quarter of
    the memory, each kernel held against them; the library call is
    scaled_dot_product_attention with the (T, T) boolean band mask, and
    its gradient."""
    import torch.nn.functional as F
    from singa_tpu_torch import kernel_check
    from singa_tpu_torch.ops import flash_attention as fa

    b, t, h, k, d, w = 1, WINDOW_T, 32, 8, 128, WINDOW_W
    dtype, scale, hc = torch.bfloat16, 1.0 / d ** 0.5, 8
    kc = hc * k // h
    q, kk, v = kernel_check.make_qkv(b, t, t, h, k, d, dtype, seed=3)
    pairs = w * (w + 1) // 2 + (t - w) * w        # in-band pairs a head
    t_bytes = q.numel() * q.element_size()
    kv_bytes = kk.numel() * kk.element_size()
    row_bytes = b * h * t * 4
    pos = torch.arange(t, device="cuda")
    band = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - w)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kk, v))

    def chunks(*xs):
        """Slices of eight query heads and their two kv heads: q and do
        (B, T, H, D), k and v (B, T, K, D), lse and delta (B, H, T, 1)."""
        for j in range(0, h, hc):
            kv = slice(j * k // h, j * k // h + kc)
            yield [x[:, :, j:j + hc] if x.shape[2] == h
                   else x[:, :, kv] if x.shape[2] == k
                   else x[:, j:j + hc] for x in xs]

    o, lse = fa._flash_fwd_cuda(q, kk, v, True, scale, w)
    errs = [kernel_check.flash_errors(
        o[:, :, j:j + hc], lse[:, j:j + hc],
        *fa._flash_fwd_reference(qc, kcc, vc, True, scale, w), dtype)
        for j, (qc, kcc, vc) in zip(range(0, h, hc), chunks(q, kk, v))]

    def plain_fwd():
        for qc, kcc, vc in chunks(q, kk, v):
            fa._flash_fwd_reference(qc, kcc, vc, True, scale, w)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                              enable_gqa=True)

    def fwd():
        return fa._flash_fwd_cuda(q, kk, v, True, scale, w)
    rows = [{"name": "flash_fwd", "shape": "mistral_w4096",
             "timed_by": "cuda_graph", "ms": graph_time_ms(fwd),
             "events_ms": cuda_time_ms(fwd),
             "plain_ms": cuda_time_ms(plain_fwd, iters=3, warmup=1),
             "library_ms": library(lambda: graph_time_ms(sdpa)),
             "library_covers": ["flash_fwd"],
             "max_abs_err": max(e["max_abs_do"] for e in errs),
             "ok": all(e["ok"] for e in errs),
             **_bound(4 * b * h * d * pairs,
                      2 * t_bytes + 2 * kv_bytes + row_bytes)}]
    g = torch.Generator("cuda").manual_seed(2)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    delta = delta.contiguous()
    args = (q, kk, v, do, lse, delta, True, scale, w)
    grads = (fa._launch_dq(*args), *fa._launch_dkv(*args))
    errs = []
    for j, (qc, kcc, vc, doc, lc, dc) in zip(
            range(0, h, hc), chunks(q, kk, v, do, lse, delta)):
        ref = fa._flash_bwd_reference(qc, kcc, vc, doc, lc, dc, True,
                                      scale, w)
        kv = slice(j * k // h, j * k // h + kc)
        errs.append(kernel_check.flash_bwd_errors(
            (grads[0][:, :, j:j + hc], grads[1][:, :, kv],
             grads[2][:, :, kv]), ref, dtype))

    def plain(fn):
        def run():
            for c in chunks(q, kk, v, do, lse, delta):
                fn(*c, True, scale, w)
        return run
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_bwd():
        og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=band,
                                            enable_gqa=True)
        return lambda: torch.autograd.grad(og, (qg, kg, vg), dot,
                                           retain_graph=True)
    lib_bwd = library(lambda: cuda_time_ms(sdpa_bwd(), iters=10))
    ok = all(e["ok"] for e in errs)
    both = ["flash_bwd_dq", "flash_bwd_dkv"]
    for name, launch, fn, mult, nbytes, err in (
            ("flash_bwd_dq", fa._launch_dq, fa._bwd_dq_reference, 6,
             3 * t_bytes + 2 * kv_bytes + 2 * row_bytes, ("dq",)),
            ("flash_bwd_dkv", fa._launch_dkv, fa._bwd_dkv_reference, 8,
             2 * t_bytes + 4 * kv_bytes + 2 * row_bytes, ("dk", "dv"))):
        def kernel(launch=launch):
            return launch(*args)
        rows.append({
            "name": name, "shape": "mistral_w4096", "timed_by": "cuda_graph",
            "ms": graph_time_ms(kernel), "events_ms": cuda_time_ms(kernel),
            "plain_ms": cuda_time_ms(plain(fn), iters=3, warmup=1),
            "library_ms": lib_bwd, "library_covers": both,
            "max_abs_err": max(e[f"max_abs_{x}"] for e in errs for x in err),
            "ok": ok, **_bound(mult * b * h * d * pairs, nbytes)})
    for r in rows:
        r["dims"] = [b, t, h, k, d]
        r["window"] = w
        r["in_band_pairs_per_head"] = pairs
    return rows


# each kernel: its source and the TPU kernel it replaces
KERNELS = {
    "flash_fwd": ("singa_tpu_torch/csrc/flash_fwd.cu",
                  "singa_tpu/ops/flash_attention.py:59"),
    "flash_bwd_dq": ("singa_tpu_torch/csrc/flash_bwd.cu",
                     "singa_tpu/ops/flash_attention.py:116"),
    "flash_bwd_dkv": ("singa_tpu_torch/csrc/flash_bwd.cu",
                      "singa_tpu/ops/flash_attention.py:159"),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; the port's serving "
              "and training paths need a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import singa_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port (singa_tpu_torch) is not importable "
              f"here ({e}); run the script from the repository's root",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    wall = {}

    def timed_phase(name, fn, *args):
        """fn(*args) with its wall seconds noted, then the card's cache
        emptied for the next phase."""
        t = time.perf_counter()
        out = fn(*args)
        wall[name] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        return out

    name = phase_card()
    with tempfile.TemporaryDirectory() as tmp:
        faults = timed_phase("build", phase_build, Path(tmp))
        timed_phase("kernels", phase_kernels)
        timed_phase("faults", phase_faults, faults)
    gen_launches, m = timed_phase("slice", phase_slice)
    serve_launches, serve_requests, serve_ctx = timed_phase(
        "serve", phase_serve, m)
    load_launches = timed_phase("load", phase_load, m, serve_ctx)
    procs, net = OpsProcs(), None
    try:
        ops_launches, ops_steps = timed_phase("ops", phase_ops)
        spec_launches, spec_requests = timed_phase("spec", phase_spec, m,
                                                   serve_ctx)
        mem_launches = timed_phase("mem", phase_mem, m, serve_ctx)
        disagg_launches = timed_phase("disagg", phase_disagg, m,
                                      serve_ctx)
        net = NetBeside(serve_ctx)
        beam_launches = timed_phase("beam", phase_beam, m)
        timed_phase("ops_procs", procs.finish)
        del serve_ctx
        park(m)                   # for the hf phase
        hf = timed_phase("hf", phase_hf, m)
        del m
        timed_phase("checkpoint", phase_checkpoint)
        timed_phase("tensor", phase_tensor)
        timed_phase("net", net.finish)
    finally:
        procs.stop()
        if net is not None:
            net.stop()
    train_launches = timed_phase("train", phase_train, faults)
    banded = timed_phase("banded", phase_banded)
    moe = timed_phase("moe", phase_moe)
    cnn_launches = timed_phase("cnn", phase_cnn)
    timed_phase("native", phase_native)
    transformer = timed_phase("transformer", phase_transformer)
    train_run_launches = timed_phase("train_run", phase_train_run)
    sonnx_launches = timed_phase("sonnx", phase_sonnx,
                                 transformer["bert"]["step"])
    rnn_launches = timed_phase("rnn", phase_rnn)
    dist_llama, dist_cnn = timed_phase("dist", phase_dist)
    spmd_launches = timed_phase("spmd", phase_spmd)
    pipe_launches = timed_phase("pipe", phase_pipe)
    rows = timed_phase("timing", phase_timing)
    window_rows = {r["name"]: r for r in rows
                   if r["shape"] == "mistral_w4096"}
    shape_rows = {(r["shape"], r["name"]): r for r in rows
                  if r["shape"] in ("gpt2_train", "bert")}
    kernels = []
    for r in rows:
        if r["shape"] != "train":
            continue
        source, replaces = KERNELS[r["name"]]
        by_path = {"train": {"launches": train_launches[r["name"]],
                             "steps": TRAIN_STEPS,
                             "per_step": train_launches[r["name"]]
                             / TRAIN_STEPS}}
        if r["name"] == "flash_fwd":
            by_path["generate"] = {"launches": gen_launches, "calls": 1,
                                   "per_call": gen_launches}
        by_path["serve"] = {"launches": serve_launches[r["name"]],
                            "requests": serve_requests}
        by_path["spec"] = {"launches": spec_launches[r["name"]],
                           "requests": spec_requests}
        by_path["mem"] = {"launches": mem_launches[r["name"]]}
        by_path["disagg"] = {"launches": disagg_launches[r["name"]]}
        if r["name"] == "flash_fwd":
            by_path["beam"] = {"launches": beam_launches, "calls": 1,
                               "per_call": beam_launches}
        by_path["load"] = {"launches": load_launches[r["name"]]}
        by_path["ops"] = {"train_point": {
            "launches": ops_launches[r["name"]], "steps": ops_steps,
            "per_step": ops_launches[r["name"]] / ops_steps}}
        for path, res in (("banded", banded), ("moe", moe)):
            tr = res["train"]
            by_path[path] = {
                "train": {"launches": tr["launches"][r["name"]],
                          "steps": TRAIN_STEPS,
                          "per_step": tr["launches"][r["name"]]
                          / TRAIN_STEPS},
                "generate": {"launches":
                             res["generate"]["launches"][r["name"]],
                             "calls": 1},
                "serve": {"launches":
                          res["serve"]["flash_launches"][r["name"]]}}
        by_path["moe"]["load"] = {"launches": moe["load"][r["name"]]}
        by_path["cnn"] = {"launches": cnn_launches[r["name"]]}
        gp = transformer["gpt2"]
        by_path["gpt2"] = {
            "train": {"launches": gp["train"][r["name"]],
                      "steps": TRAIN_STEPS,
                      "per_step": gp["train"][r["name"]] / TRAIN_STEPS},
            "generate": {"launches": gp["generate"][r["name"]],
                         "calls": 1},
            "serve": {"launches": gp["serve"][r["name"]]}}
        by_path["gpt2_remat"] = {
            "launches": gp["remat"][r["name"]], "steps": REMAT_STEPS,
            "per_step": gp["remat"][r["name"]] / REMAT_STEPS}
        by_path["rnn"] = {"launches": rnn_launches[r["name"]]}
        by_path["hf"] = {
            name: {"generate": {"launches": res["generate"]["launches"][
                       "imported"][r["name"]], "calls": 1},
                   **({"train": {"launches": res["train"]["runs"][
                       "imported"]["launches"][r["name"]],
                       "steps": HF_STEPS}} if "train" in res else {})}
            for name, res in hf.items()}
        by_path["train_run"] = {
            "launches": train_run_launches[r["name"]],
            "steps": RUN_STEPS,
            "per_step": train_run_launches[r["name"]] / RUN_STEPS}
        by_path["bert"] = {"train": {
            "launches": transformer["bert"]["train"][r["name"]],
            "steps": TRAIN_STEPS}}
        by_path["sonnx"] = {
            "bert_train": {"launches":
                           sonnx_launches["bert_train"][r["name"]],
                           "steps": TRAIN_STEPS},
            "gpt2_eval": {"launches": sonnx_launches["gpt2_eval"][r["name"]],
                          "calls": sonnx_launches["gpt2_calls"]}}
        by_path["dist"] = {
            **{f"base_{mode}": {"launches": n[r["name"]],
                                "steps": TRAIN_STEPS,
                                "per_step": n[r["name"]] / TRAIN_STEPS}
               for mode, n in dist_llama.items()},
            "resnet50": {"launches": dist_cnn[r["name"]]}}
        by_path["spmd"] = {
            "base_train": {"steps": TRAIN_STEPS, "per_step":
                           spmd_launches["base_train"]["per_step"][r["name"]]},
            "ring": {case: n[r["name"]]
                     for case, n in spmd_launches["ring"].items()}}
        by_path["pipe"] = {case: n[r["name"]]
                           for case, n in pipe_launches.items()}

        def at(row):
            return {key: row[key] for key in (
                "dims", "window", "causal", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_covers", "max_abs_err",
                "share_of_bound") if key in row}
        at_window = at(window_rows[r["name"]])
        kernels.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[r["name"]],
            "launches_by_path": by_path, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_covers": r["library_covers"],
            "timed_by": r["timed_by"], "at_mistral_w4096": at_window,
            **{f"at_{sh}": at(row) for (sh, name), row in shape_rows.items()
               if name == r["name"]}})
    emit({"phase": "end", "script_seconds": time.perf_counter() - t0,
          "phase_wall_s": wall, "clocks_after_timing": card_clocks()})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
