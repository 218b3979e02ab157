#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`k3m_tpu_torch`).

    python3 chip_smoke.py                  # every phase, one CUDA card
    python3 chip_smoke.py --kernels-only   # phases 1-3 only, no result line
    python3 chip_smoke.py --profile        # also trace the serving forward
    python3 chip_smoke.py --parent DIR     # also time DIR's LN forward kernel (phase 3)
    python3 chip_smoke.py --ln-paths [--parent DIR]  # phases 4, 6, 8 for the LN forward, alone
    python3 chip_smoke.py --moe-kernels    # phase 3's MoE part, alone
    python3 chip_smoke.py --dp-cards 4     # phase 17's finetune on 4 cards, alone
    python3 chip_smoke.py --tp-cards 4     # --n_model pretraining on 4 cards, alone

Phases, in order; any failure exits non-zero and no phase carries on past
a failure:
  1. environment: torch/CUDA versions, card name and power limit;
  2. build: compile the CUDA kernels from k3m_tpu_torch/kernels/csrc/ and
     report each kernel's registers, static shared memory and spill bytes
     from ptxas;
  3. kernels: hold each kernel against its plain PyTorch version on the
     card, in fp32 and bf16, at every main-path shape (forward kernels at
     the serving batch 64 and the pretraining batch 96, backward kernels at
     96; the attention kernels also in bf16 at rate 0.1 at the finetune
     batch 32, as finetune training calls them, and both LN kernels there
     on the pv rows in bf16),
     forward kernels at dropout 0 and 0.1, backward kernels at 0 and 0.1
     under the plain version's Philox mask, each (batch, head) of a
     gradient within a share of its own scale, and show that this
     tolerance rejects planted faults; read the forward kernels' dropout masks
     back and hold them to `philox_keep_mask_plain` bit for bit, and their
     keep rate to 0.9 within 4 sigma; hold both forward kernels to their
     plain versions (output, lse, mask words) at the edges of their tiles
     (lengths 1 to 256, D 64/96/128); time the kernel, the plain version
     and (where one PyTorch call computes the same function) the library
     call; then the host's cost of one wrapper call; then #3/#4/#5 at the
     head counts of 2 and 4 model ranks (tensor parallelism: text 6/3
     heads, image and co-attention 4/2) at batch 96, bf16 at rate 0.1 and
     fp32 at rate 0, the rank's heads the last of the layer's, their mask
     words bit for bit the head slice of the layer's mask (tp_kernel_rows);
     then every kernel at the shapes the trunk options give it
     (option_kernel_rows, batch 96, fp32 and bf16 at rate 0 and 0.1): #3/#4
     at H12 D64 L51 and L257 (task tokens; L257 one row past four 64-row
     tiles, its mask words bit for bit) and L87 (the single-stream
     baseline), #5 at 37<->51, 37<->257 and 257<->51, #1/#2 on 96 x 257 pv
     rows of 768; then #1-#4 at the shapes packed_passes and fused_qkv give
     them (packed_kernel_rows, fp32 and bf16 at rate 0 and 0.1): #1/#2 on
     the packed text rows [96 * 612, 768] and [32 * 612, 768] and the image
     stack's [192 * 37, 1024], #3/#4 at H8 L37 D128 on the image stack's
     192 rows and at H12 D64 L50/L256 on views of one fused [96 * 612,
     2304] projection at their packed row offsets; the LN forward (#1)
     also at its edges (ln_edge_rows): one row, a row count that is no
     multiple of a block's warps, fewer rows than the persistent grid has
     blocks, widths of 1 to 128 groups of 8 with and without predicated
     lanes, every dtype combination, with its rstd, each twice bit for bit,
     by its vector instance and by its per-element one, and the shapes the
     per-element instance alone takes (a width of 100, a view one element
     off), with both launch counters; the DeepSeek-V2 MoE's six per-pair
     kernels (kernels/moe.py, moe_kernel_rows) at the
     pretrain-dsv2lite-ep8-b16 cell's shapes, each against its plain
     version on a held range of 8 of 64 experts, every expert held, none,
     one expert in every row and a valid mask cleared for the first held
     expert, at tests/test_torch_moe_kernels.py's limits, with its launch
     count, timed on the held range beside its plain version and its byte
     bound, then one MoE layer's forward and backward: the kernels' launch
     counts, its tensors against the plain versions', and the held experts'
     and the layer's ms on the kernels and on the plain versions; every #1
     row is timed by the vector
     instance and, with --parent DIR, by the LN forward of DIR (a checkout
     of another commit, its layernorm.cu built alone), rotating over
     copies of the inputs where their bytes fall short of twice the 50 MB
     L2; each part's seconds are printed;
  4. slice (serving): write 256 synthetic pair records at the full shapes
     of run_pred.sh and run `k3m_tpu_torch.finetune --do_pred --bf16` over
     them with the bert_base_6layer_6conect config (random weights from a
     seed); check the jsonl and that every kernel counter grew by the
     expected launch count; report pairs/s, the loader alone and the model
     forward alone (and, with --profile, device time by kernel class);
  5. cross-check (serving): one 2-pair batch in fp32 through the same
     weights on the card (kernels) and on the CPU (plain versions);
  6. train: write 9 batches of 96 synthetic pretraining records at the
     full shapes and run `k3m_tpu_torch.pretrain --bf16 --use_image
     --train_batch_size 96` with the k3m_roberta_base config (random
     weights from a seed); check every step's losses are finite and every
     kernel counter, forward and backward, grew by the count the config
     gives; report samples/s and step ms over the steps after the first,
     peak memory, the epoch checkpoint's write, and device time by kernel
     class of one more step under the profiler, its busy ms beside the
     mean step;
  7. train cross-check: one fp32 train step at batch 2, dropout off,
     injected LPM negatives and Gumbel noise, on the card (kernels) and on
     the CPU (plain versions): the four losses and every parameter's
     gradient;
  8. finetune: write 9 batches of 32 synthetic training pairs and 64
     validation pairs at the full shapes and run `k3m_tpu_torch.finetune
     --do_train --do_eval` with the flags of run_finetune_item_alignment.sh
     (bf16, loss inner, fusion strategy 1, dropout 0.1, batch 32) and the
     bert_base_6layer_6conect config (random weights from a seed); check
     every step's loss is finite, every kernel counter, forward and
     backward, grew by the count the config gives, the threshold sweep and
     the epoch checkpoint, and that staged_prefetch stages the loader's
     batches on the card bit for bit; report pairs/s and step ms over the
     steps after the first, peak memory, and device time by kernel class
     of one more step under the profiler, its busy ms beside the mean step;
  9. finetune cross-check: one fp32 finetune train step at batch 2, dropout
     off, fusion strategy 2, for loss inner and ce, on the card and on the
     CPU: the loss and every parameter's gradient;
 10. native producer: the C++ record reader and batch producer of
     k3m_tpu_torch/runtime (built with g++ at first use, alongside the CUDA
     build; its build seconds and g++'s version printed): both full-width
     loaders (pretraining at batch 96, pairs at batch 32, on the records of
     phases 6 and 8) must run it, their batches must equal the Python
     producer's byte for byte, and each producer's seconds per batch are
     printed. Phases 6 and 8 train on the native producer (the CLIs'
     default) and then train one more epoch on the Python producer, so
     that samples/s and pairs/s of both stand side by side in one run;
 11. preemption and resume: `k3m_tpu_torch.pretrain` (k3m_roberta_base at
     DEPTH_CUT), batch 96, under torch.use_deterministic_algorithms: an
     uninterrupted epoch;
     the same epoch with --save_steps, SIGTERM delivered mid-epoch (a step
     checkpoint, then the run returns); a run resumed from latest.json;
     every parameter and AdamW moment of the resumed run against the
     uninterrupted run's, bit for bit unless an op on the path has no
     deterministic implementation (then named, with the tolerance);
 12. pretrain -> finetune: `k3m_tpu_torch.finetune --do_train` starts from
     phase 6's model file (`epoch_0/pytorch_model.bin`, k3m_roberta_base)
     with loss inner at learning rate 0: every weight of the alignment
     model equal to the file's, bit for bit;
 13. int8 wire: one full-width bf16 train step with the int8 wire against
     the exact wire (losses within rtol 2e-2), and the host->card bytes of
     one batch under fp, int8 and exact;
 14. device cache: two epochs of `k3m_tpu_torch.pretrain --device_cache`
     (k3m_roberta_base at DEPTH_CUT): the second replayed from the cache, whose batches
     equal, bit for bit, the first epoch's streamed ones; the cached bytes
     against the budget;
 15. extract: write a seeded detectron2-layout pkl (1600 classes) and 16
     PPM images of five raw sizes (three canvases), run `python -m
     k3m_tpu_torch.data.prepare --item_info --image_dir --extract_features
     --extract_batch_size 4 --frcnn_weights` on the card (R101-C4, 600/1000,
     6000 -> 300 proposals, 36 objects, fp32 with TF32 off); check every
     record (0-36 boxes inside the raw image, at least half at 36, finite
     [n, 2048] features, cls_prob rows summing to 1), that no image went
     through the per-image fallback and that no port kernel ran; read a
     batch through the port's PretrainLoader; report images/s over the
     flushes after the first, then one batch of 4 images in one canvas:
     stream ms and peak memory per stage beside each stage's bound, kernel
     launches and busy share under the profiler;
 16. extract cross-check: one image at min/max size 240/400 through the
     same weights on the card and on the CPU, stage by stage (backbone
     map, RPN logits and deltas, pooled and box features, probabilities
     within 1e-4 of their scale); the discrete stages (stable top-k, the
     proposal NMS, the class NMS sweep) run on the CPU from the card's
     continuous tensors equal the card's index for index;
 17. dp_train: phase 8's finetune (bf16, dropout 0.1, global batch 32, 3
     steps and the sweep; the config at DEPTH_CUT: 4 text layers, 2 image
     layers, 2 co-attention blocks of each kind), all at once, as one
     plain process and as a world of one over NCCL (torchrun's variables),
     both under torch.use_deterministic_algorithms, and as two ranks
     sharing the card over gloo (the K3M_* variables,
     K3M_DIST_BACKEND=gloo, LOCAL_RANK 0):
     the NCCL world of one equals the plain run bit for bit; the two ranks
     end with bit-identical parameters and the same sweep, each launched
     the per-step kernel counts, and their global losses lie within 2^-6 of
     one process trained on the same global batches; pairs/s, step ms, the
     gradient all-reduce's ms and bytes a step, peak memory per rank (gloo
     through the host on one card: no scaling figure);
 18. dp_crosscheck: one fp32 pretraining step (k3m_roberta_base at
     DEPTH_CUT), global batch 4 = 2 ranks x 2 rows, dropout 0.1 and the step's own draws, a
     zero-pair item planted as rank 1's first row: two gloo ranks on the
     card against one process on the card, phase 7's limits on the four
     losses and every gradient after the all-reduce;
 19. dp_predict: phase 4's `finetune --do_pred --bf16` in two gloo ranks:
     the parts `.part0` and `.part1` together hold phase 4's pairs, scores
     within 2^-6;
 20. legacy_extract: `python -m k3m_tpu_torch.data.legacy_tsv extract
     --batch_size 4 --weights` over phase 15's images with its pkl on the
     card, then `serialize` against a df CSV: each TSV row against phase
     15's record of the same image (box count equal; boxes, features and
     cls_prob within 1e-4 of their scale), the "b'...'" framing, read_tsv
     against the rows, the serialized records field for field, no
     per-image fallback; phase 15's records through ImageFeaturesReader
     (global token, location layout); images/s;
 21. legacy_train: (a) the README's quick-start command through `python -m
     k3m_tpu_torch.train_concap_struc --do_train --do_eval
     --train_batch_size 96 --max_seq_length 50 --max_seq_length_pv 256
     --max_num_pv 30 --bf16` (bert_base_6layer_6conect, random weights from
     a seed) on 9 batches of phase 6's records and a valid sibling: every
     step's losses finite, every kernel counter grown by the count the
     config gives (9 steps and 2 eval forwards), hyperparamter.txt and the
     epoch checkpoint; samples/s, step ms, peak memory, device busy ms of one
     more profiled step; then the first 3 steps of this CLI and of
     `k3m_tpu_torch.pretrain` with the matching flags on the same records
     (the config at DEPTH_CUT),
     under torch.use_deterministic_algorithms: losses and parameters bit for
     bit; (b) the CLI's default shapes (title 36, pv 128, 20 pvs) at batch
     96, 3 steps at DEPTH_CUT, counts as the config gives, then every kernel held against
     its plain version at these shapes as phase 3 holds them (#3/#4/#5 in
     bf16 at rate 0.1 and fp32 at rate 0, forward and backward; #1/#2 on
     these rows), timed with bound and library call; (c) a raw TSV of 96
     rows with a valid sibling, converted once by find_records, one step
     (DEPTH_CUT), reused by a second run;
 22. tp_crosscheck: two gloo ranks with --n_model 2 sharing the card
     against one process on the card, fp32, dropout 0.1 with the step's
     own draws: one pretraining step (k3m_roberta_base at DEPTH_CUT, global
     batch 4), the four losses and every gathered gradient to phase 7's
     limits; one finetune step (bert_base_6layer_6conect at DEPTH_CUT, loss
     inner, batch 2) to phase 9's; and
     eight gloo ranks with --n_model 8 (k3m_roberta_base's widths and
     heads, cut to 2 text layers, 1 image layer and one co-attention block
     of each kind: the 12 text heads run replicated on every rank, the 8
     image and co-attention heads one a rank), one pretraining step at
     global batch 4 against one process at the same cut, phase 7's limits,
     every attention call's mask words bit for bit one process's;
 23. tp_train: `k3m_tpu_torch.pretrain`, `finetune --do_train --do_eval
     --do_pred` and `train_concap_struc`, each with --n_model 2 as two gloo
     ranks sharing the card, bf16, the shipped widths at DEPTH_CUT, 3 steps
     at small global batches (pretraining 16, finetune 8 pairs, legacy
     16): both model ranks report the same losses, each launches every
     kernel the count the config gives, rank 0's model file has full
     shapes and loads into a one-process model bit for bit, the predict
     file equals one process's predict within 2^-6; step ms, the
     model-group all-reduces' bytes and host ms a step, peak memory per
     rank;
 24. trunk_options (run by phase 22 while its ranks run, after its
     references): the config's trunk options at full width, each once
     in bf16 with the launch counts the config gives and cross-checked in
     fp32 card (kernels) vs CPU (plain versions) at batch 2, outputs at
     phase 5's limit and every gradient at phase 7's: (a) K3MTrunk with
     task_ids (bert_base_6layer_6conect, B8, text streams 51 and 257
     long), forward and backward; (b) TriStreamEncoder with fast_mode
     (k3m_roberta_base), forward and backward at equal batches of 8 and at
     a text batch of 1 against 8, and in fp32 on the card equal to the
     encoder fed the text row repeated; (c) TriStreamEncoder with
     in_batch_pairs at b 8 (64 pair rows), forward and backward, and in
     fp32 on the card equal to the encoder fed the rows repeated and tiled
     per pass; (d) forward_with_attention on K3MTrunk with visualization
     (bert_base_6layer_6conect, B4): the JAX package's count of maps per
     site, rows summing to 1 within 2e-2, no attention kernel, and in fp32
     the outputs of the kernel path; (e) BaseBertForPretraining, 12 layers
     of 768 over title 50 + 37 image tokens, 3 bf16 AdamW steps at B32,
     losses and gradients cross-checked;
 25. packed (packed_passes and fused_qkv): (a) phase 7's fp32 train step
     with both flags, card vs CPU, phase 7's limits; (b) TriStreamEncoder
     (k3m_roberta_base, fp32, dropout 0) with both flags against the
     sequential encoder on the card: outputs at phase 5's limit, every
     gradient at phase 7's, the launch counts of each; (c) `python -m
     k3m_tpu_torch.pretrain --bf16 --use_image --train_batch_size 96`
     through a --config_file that sets packed_passes, then fused_qkv, then
     both, 5 steps each: every kernel counter against the flag-aware
     formula (layer_counts), samples/s, step ms, launch calls and busy ms
     of one profiled step, peak memory, beside phase 6's run without them;
     (d) `finetune --do_train` (bert_base_6layer_6conect, batch 32) with
     both flags, 5 steps, reported the same way;
 26. grain (ArrayRecord files and the grain backend): (a) phase 6's 864
     records written to an .array_record by the port's writer (seconds,
     MB beside the .k3mr's) and read back, every payload byte for byte the
     K3MR reader's; libzstd's version and where it was found; (b)
     GrainPretrainLoader at batch 96, shuffled: its first 4 batches made
     in-process, by 2 spawned worker processes and by the native hybrid
     (the .k3mr sibling) byte for byte equal, each producer's samples/s
     over batches 2-4 and the first batch's seconds; (c) `python
     -m k3m_tpu_torch.pretrain --bf16 --use_image --train_batch_size 96
     --data_backend grain --num_workers 2` (k3m_roberta_base) for 5 steps
     on an .array_record with no sibling: finite losses, every kernel
     counter at the count the config gives, samples/s, step ms, launch
     calls and busy ms of one profiled step beside phase 6's run (a
     reading, not a claim);
 27. print the kernel summary line and the final device line.

Phases 17-19 and 22-23 run their ranks as `python3 chip_smoke.py
--dp-worker <spec>` processes (logs in chiprun_out/dp_*.log); a rank that
exits non-zero, or a phase that outlives its timeout, fails the script.
`--tp-cards N` runs `k3m_tpu_torch.pretrain` at full width and global
batch 96 on one card, then on N NCCL ranks one per card with --n_model N
(on 4 cards also 2 data x 2 model), alone (chiprun_out/tp_cards.json).

Phases 11, 12 and 14 hold the kernel launch counts of their runs to what
the config gives, as phases 6 and 8 do; phases 4, 6 and 8, and every
phase that checks its counts through `_check_launches`, also hold the LN
forward's per-element instance to 0 launches.
`--ln-paths` runs phases 4 (profiled), 6 and 8 alone, each run in a
process of its own, and reduces them to the LN forward's device ms and
launches in the profiled serving forward and train steps, with the device
forward ms, the step rates and the LN wrapper's host cost per call
(`launch_overhead`); with --parent DIR, DIR's chip_smoke.py and this
tree's in turns: parent, this tree, this tree, parent, parent, this tree
(chiprun_out/ln_paths.json, each run's log in chiprun_out/ln_paths_<n>.log).
Each phase's wall seconds are printed and kept. Every checkpoint is written under build/chip_smoke/ and
deleted once checked.

Exits non-zero without a result when CUDA is not available. Writes its
data under build/chip_smoke/ and its detailed results to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import itertools
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
OUT_JSON = ROOT / "chiprun_out" / "chip_smoke.json"

# H100 SXM published peaks (NVIDIA data sheet; dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

BATCH = 64           # the serving phase's eval batch
TRAIN_BATCH = 96     # the train phase's batch = the kernel phase's batch
TRAIN_STEPS = 9      # the first is the warm-up
FT_BATCH = 32        # the finetune phase's batch (run_finetune_item_alignment.sh)
FT_STEPS = 9         # the first is the warm-up
FT_VALID = 64        # validation pairs of the finetune phase's sweep
N_PAIRS = 256
SEED = 1234
SHAPES = dict(max_seq_length=50, max_seq_length_pv=256, max_num_pv=30,
              max_region_length=36)
RATES = (0.0, 0.1)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ timing

TIMED_ITERS = 10   # calls in each timed graph (kept small for the script's time)
PLAIN_ITERS = 3    # the same for the plain versions, 10-100x the kernels' time


def graph_ms(fn, iters=TIMED_ITERS, warmup=3):
    """Device ms per call of `fn`: `iters` calls captured in one CUDA graph
    and replayed, so that the host's cost of a call (measured apart, in
    launch_overhead) does not stand in for the time of a small kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):            # warm-up outside the graph
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


L2_BYTES = 50e6   # the H100's L2


def l2_copies(nbytes):
    """Copies of a call's inputs (`nbytes` of them) to rotate over when
    timing it, so that each call finds its inputs in device memory as the
    main path does: enough that the copies' bytes reach twice the L2; one
    where a single call's do."""
    return 1 if nbytes >= 2 * L2_BYTES else math.ceil(2 * L2_BYTES / nbytes)


def rotated_ms(call, inputs, iters=TIMED_ITERS):
    """graph_ms of `call(*args)` cycling over `inputs` (one tuple of
    arguments per copy), at least one call per copy in the graph."""
    it = itertools.cycle(inputs)
    return graph_ms(lambda: call(*next(it)), max(iters, len(inputs)))


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tolerance(ref, dtype):
    """fp32: 2e-5 of the output scale (sum order and rsqrt/exp rounding);
    bf16: 2^-6 of the output scale, at least two bf16 ulps there: the
    kernel rounds twice (the probabilities for the tensor cores, then the
    output) where the plain version rounds once, and either rounding may
    land on the neighbouring bf16 value."""
    scale = max(1.0, float(ref.float().abs().max()))
    return scale * (2e-5 if dtype == torch.float32 else 2.0 ** -6)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------ phases

def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads")
PTXAS_USED = re.compile(r"Used (\d+) registers")
PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names):
    """Readable kernel names (c++filt where the toolkit's binutils have it;
    the mangled names otherwise, which still say what they are)."""
    if not names or shutil.which("c++filt") is None:
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(log_text):
    """Per kernel, from the build's `-Xptxas -v` log: registers per thread,
    static shared memory (the forward and backward tiles take theirs
    dynamically, at launch) and spill bytes."""
    rows, cur = [], None
    for line in log_text.splitlines():
        if m := PTXAS_ENTRY.search(line):
            cur = dict(kernel=m.group(1))
            rows.append(cur)
        elif cur is not None and (m := PTXAS_SPILL.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := PTXAS_USED.search(line)):
            smem = PTXAS_SMEM.search(line)
            cur.update(registers=int(m.group(1)), smem_static=int(smem.group(1)) if smem else 0)
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def phase_build():
    from k3m_tpu_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build(verbose=True)
    build.library()
    secs = time.perf_counter() - t0
    log(f"build: {path} in {secs:.2f} s")
    ptxas = path.parent / "ptxas.log"
    report = []
    if ptxas.exists():
        OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ptxas, OUT_JSON.parent / "ptxas.log")
        report = ptxas_report(ptxas.read_text())
        for r in report:
            if "mma_kernel" in r["kernel"] or ("ln_fwd_vec" in r["kernel"] and (
                    "__nv_bfloat16, __nv_bfloat16, __nv_bfloat16" in r["kernel"])):
                log(f"ptxas {r['kernel']}: {r.get('registers')} registers, "
                    f"{r.get('spill_stores')} bytes spill stores, {r.get('spill_loads')} "
                    f"bytes spill loads, {r.get('smem_static')} bytes static smem")
        vec = [r for r in report if "ln_fwd_vec" in r["kernel"]]
        if vec:       # the LN forward's vector instance takes its rings dynamically
            log(f"ptxas ln_fwd_vec_kernel: {len(vec)} instantiations, registers "
                f"{min(r['registers'] for r in vec)}-{max(r['registers'] for r in vec)}, "
                f"spill stores {sum(r.get('spill_stores', 0) for r in vec)} bytes in all, "
                f"{sum(bool(r.get('spill_stores')) for r in vec)} spilling")
    return secs, report


def ln_shapes(batch):
    return ((batch * 50, 768, "title"), (batch * 256, 768, "pv"), (batch * 37, 1024, "image"))


FWD_BATCHES = (BATCH, TRAIN_BATCH)     # the forward kernels run on both main paths


def attention_cases(batches_dtypes_rates):
    """(batch, dtype, rate) of the attention rows: fp32 and bf16 at rate 0
    and 0.1 at the serving and pretraining batches; at the finetune batch
    the bf16 training call (rate 0.1) alone."""
    for B in batches_dtypes_rates:
        if B == FT_BATCH:
            yield B, torch.bfloat16, 0.1
            continue
        for dt in (torch.float32, torch.bfloat16):
            for rate in RATES:
                yield B, dt, rate


TRAINING_BATCHES = (TRAIN_BATCH, FT_BATCH)   # forward kernels timed keeping lse and words
PACKED_IMAGE_BATCH = 2 * TRAIN_BATCH         # packed_passes' image stack: [img; img]


def _bound(nbytes, ops, dtype):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def _record(rows_out, card, **row):
    rows_out.append(row)
    lib = row.get("library_ms")
    log(f"kernel {row['kernel']} {row['shape']} {row['dtype']} rate {row.get('rate', 0.0)}"
        f"{' res' if row.get('residual') else ''}: max_abs_err {row['max_abs_err']:.3e} "
        f"(tol {row['tol']:.1e}) kernel_ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
        f"library_ms {'None' if lib is None else f'{lib:.4f}'} bound_ms "
        f"{row['bound_ms']:.4f} ({row['bound_by']}) | {card}")
    if not row["max_abs_err"] <= row["tol"]:
        raise AssertionError(f"{row['kernel']} {row['shape']} disagrees: "
                             f"{row['max_abs_err']} > {row['tol']}")


def _worst(pairs):
    """The (error, tolerance) pair of the output closest to its limit."""
    return max(pairs, key=lambda et: et[0] / et[1])


def _dt_name(dt):
    return str(dt).replace("torch.", "")


PARENT_DIR = None    # --parent DIR: a checkout whose LN forward phase 3 also times
_parent_ln = []


def parent_layernorm():
    """The LN forward of PARENT_DIR (its csrc/layernorm.cu built alone by
    nvcc into a library of its own; its C interface has no instance
    argument) as f(x, scale, bias, residual, out_dtype) -> out; None
    without --parent."""
    if PARENT_DIR is None:
        return None
    if not _parent_ln:
        import ctypes

        from k3m_tpu_torch.kernels import build
        csrc = Path(PARENT_DIR).resolve() / "k3m_tpu_torch" / "kernels" / "csrc"
        lib_path = ROOT / "build" / "parent_ln" / "libparent_ln.so"
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                        "-fPIC", "-shared", "-I", str(csrc), str(csrc / "layernorm.cu"),
                        "-o", str(lib_path)], check=True, capture_output=True, text=True)
        log(f"parent LN forward: {csrc / 'layernorm.cu'} built in "
            f"{time.perf_counter() - t0:.1f} s")
        lib = ctypes.CDLL(str(lib_path))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.k3m_layernorm_fwd.argtypes = [P, I, P, I, P, P, P, I, P, I, I, F, P]
        lib.k3m_layernorm_fwd.restype = I
        codes = build.DTYPE_CODES

        def call(x, scale, bias, res, out_dtype):
            n = x.shape[-1]
            out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
            rc = lib.k3m_layernorm_fwd(
                x.data_ptr(), codes[x.dtype], None if res is None else res.data_ptr(),
                0 if res is None else codes[res.dtype], scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), codes[out_dtype], None, x.numel() // n, n, 1e-12,
                build.stream_handle(x.device))
            build.check(rc, "parent k3m_layernorm_fwd")
            return out
        _parent_ln.append(call)
    return _parent_ln[0]


def kernel_phase_layernorm(card, rows_out, cases=None):
    """The forward kernel against layernorm_plain, with and without a
    residual, by the instance the wrapper picks (the vector one at every
    shape here, which the counters show); `cases`: [(batch, (rows, n,
    what), ((in, out dtype), ...))], by default every main-path shape.
    Timed: the vector instance (`ms`), the parent's kernel with --parent,
    the plain version, and without a residual F.layer_norm; with a residual
    the two-call F.layer_norm(x + r) as a reading (no one PyTorch call
    computes the function). Where the inputs' bytes fall short of twice the
    L2 the timed calls rotate over copies of them (`l2_copies`, the outputs
    not rotated)."""
    import torch.nn.functional as F

    from k3m_tpu_torch.kernels import fused_layernorm, layernorm_plain
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    parent = parent_layernorm()
    if cases is None:
        # every shape of the serving and pretraining batches; at the
        # finetune batch the pv rows in bf16, the summary's row
        cases = [(b, shape, ((f32, f32), (bf16, bf16), (f32, bf16)))
                 for b in FWD_BATCHES for shape in ln_shapes(b)]
        cases.append((FT_BATCH, ln_shapes(FT_BATCH)[1], ((bf16, bf16),)))
    for batch, (rows, n, what), dtypes in cases:
        for with_res in (False, True):
            for xd, od in dtypes:
                x = (torch.randn(rows, n, generator=g, device="cuda") * 2 + 1).to(xd)
                res = torch.randn(rows, n, generator=g, device="cuda").to(xd) \
                    if with_res else None
                scale = torch.randn(n, generator=g, device="cuda")
                bias = torch.randn(n, generator=g, device="cuda")
                counts = (fused_layernorm.launches, fused_layernorm.per_element_launches)
                out = fused_layernorm(x, scale, bias, res, out_dtype=od)
                if (fused_layernorm.launches - counts[0],
                        fused_layernorm.per_element_launches - counts[1]) != (1, 0):
                    raise AssertionError(f"fused_layernorm [{rows},{n}] {what}: not the "
                                         "vector instance")
                ref = layernorm_plain(x, scale, bias, res, out_dtype=od)
                torch.cuda.synchronize()
                elem = rows * n
                in_bytes = elem * (x.element_size() + (res.element_size() if with_res else 0))
                copies = l2_copies(in_bytes)
                inputs = [(x, res)] + [(x.clone(), None if res is None else res.clone())
                                       for _ in range(copies - 1)]
                lib = two_call = None
                if xd == od:
                    sx, bx = scale.to(xd), bias.to(xd)
                    if res is None:
                        lib = rotated_ms(lambda a, r: F.layer_norm(a, (n,), sx, bx, 1e-12),
                                         inputs)
                    else:
                        two_call = rotated_ms(
                            lambda a, r: F.layer_norm(a + r, (n,), sx, bx, 1e-12), inputs)
                extra = {}
                if parent is not None:
                    extra["parent_ms"] = rotated_ms(
                        lambda a, r: parent(a, scale, bias, r, od), inputs)
                if two_call is not None:
                    extra["two_call_library_ms"] = two_call
                nbytes = in_bytes + elem * torch.empty(0, dtype=od).element_size() + 2 * n * 4
                bound, by = _bound(nbytes, elem * (8 if with_res else 7), f32)
                _record(rows_out, card, kernel="fused_layernorm", shape=f"[{rows},{n}] {what}",
                        batch=batch, residual=with_res,
                        dtype=f"{_dt_name(xd)}->{_dt_name(od)}",
                        max_abs_err=max_err(out, ref), tol=tolerance(ref, od),
                        ms=rotated_ms(lambda a, r: fused_layernorm(a, scale, bias, r,
                                                                   out_dtype=od), inputs),
                        plain_ms=graph_ms(lambda: layernorm_plain(x, scale, bias, res,
                                                                  out_dtype=od),
                                          PLAIN_ITERS, 1),
                        library_ms=lib, bound_ms=bound, bound_by=by, instance="vector",
                        l2_copies=copies, **extra)
                del inputs
                log(f"  LN forward [{rows},{n}] {what} {_dt_name(xd)}->{_dt_name(od)}"
                    f"{' res' if with_res else ''}: "
                    f"{ {k: round(v, 4) for k, v in extra.items()} } l2_copies {copies}")


# the LN forward's edges: (rows, n, what, dtype combinations (x, residual
# or None, out)); the vector instance takes them all
LN_EDGE_SHAPES = (
    (1, 768, "one row"), (1, 1024, "one row"),
    (4099, 768, "rows no multiple of a block's 8 warps"),
    (4099, 1024, "rows no multiple of a block's 8 warps"),
    (200, 1024, "fewer rows than the grid's blocks"),
    (77, 8, "one group of 8"), (77, 256, "one group a lane"), (77, 512, "two groups a lane"),
    (77, 520, "65 groups: predicated lanes"), (77, 1016, "127 groups: predicated lanes"),
)


def _ln_edge_dtypes(rows, n):
    f32, bf16 = torch.float32, torch.bfloat16
    if (rows, n) == (4099, 768):              # every combination once
        return [(xd, rd, od) for xd in (f32, bf16) for rd in (None, f32, bf16)
                for od in (f32, bf16)]
    return [(bf16, bf16, bf16), (bf16, None, bf16), (f32, f32, f32), (f32, bf16, bf16)]


def ln_edge_rows(card):
    """The LN forward at its edges, fp32 out and rstd against the plain
    version's: the output at phase 3's tolerance, the rstd within 1e-5 of
    each value; each call twice, bit for bit. At LN_EDGE_SHAPES the wrapper
    must pick the vector instance, and the per-element one (asked for) is
    held the same way; a width of 100 and views one element off (x, and
    the residual) must take the per-element instance, and the vector
    instance asked for there must refuse. Both launch counters are held
    to the calls made."""
    from k3m_tpu_torch.kernels import fused_layernorm
    from k3m_tpu_torch.kernels.layernorm import _forward, _plain_fwd
    g = torch.Generator(device="cuda").manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16
    rows_out, vector_calls, element_calls = [], 0, 0
    fused_layernorm.launches = fused_layernorm.per_element_launches = 0

    def make(rows, n, xd, rd, x_off=0, r_off=0):
        x = (torch.randn(rows * n + x_off, generator=g, device="cuda") * 2 + 1)
        x = x.to(xd)[x_off:].view(rows, n)
        res = None
        if rd is not None:
            res = torch.randn(rows * n + r_off, generator=g, device="cuda").to(rd)
            res = res[r_off:].view(rows, n)
        return (x, torch.randn(n, generator=g, device="cuda"),
                torch.randn(n, generator=g, device="cuda"), res)

    def hold(x, s, b, res, od, instance, what):
        got = _forward(x, s, b, res, 1e-12, od, True, instance)
        again = _forward(x, s, b, res, 1e-12, od, True, instance)
        want = _plain_fwd(x, s, b, res, 1e-12, od)
        torch.cuda.synchronize()
        err, tol = max_err(got[0], want[0]), tolerance(want[0], od)
        rstd_err = float(((got[1] - want[1]).abs() / want[1].abs()).max())
        same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        row = dict(what=what, shape=list(x.shape), instance=instance or "picked",
                   dtypes=[_dt_name(t.dtype) if t is not None else None for t in (x, res)]
                   + [_dt_name(od)], max_abs_err=err, tol=tol, rstd_rel_err=rstd_err,
                   twice_bit_identical=same)
        rows_out.append(row)
        if not (err <= tol and rstd_err <= 1e-5 and same):
            raise AssertionError(f"LN forward edge {row}")
        return row

    for rows, n, what in LN_EDGE_SHAPES:
        for xd, rd, od in _ln_edge_dtypes(rows, n):
            args = make(rows, n, xd, rd)
            hold(*args, od, None, what)
            vector_calls += 2
            hold(*args, od, "per_element", what)
            element_calls += 2
    for n, x_off, r_off, what in ((100, 0, 0, "width 100"), (768, 1, 0, "x one element off"),
                                  (768, 0, 1, "residual one element off"),
                                  (1024, 1, 1, "both one element off")):
        for xd, od in ((bf16, bf16), (f32, f32)):
            x, s, b, res = make(333, n, xd, xd, x_off, r_off)
            hold(x, s, b, res, od, None, what)
            element_calls += 2
            try:                               # refused: nothing launched or counted
                _forward(x, s, b, res, 1e-12, od, True, "vector")
            except RuntimeError:
                continue
            raise AssertionError(f"LN forward {what}: the vector instance took it")
    counts = (fused_layernorm.launches, fused_layernorm.per_element_launches)
    log(f"LN forward edges: {len(rows_out)} rows within tolerance, each twice bit for bit; "
        f"launches {counts[0]}, per-element {counts[1]} (expected "
        f"{vector_calls + element_calls}, {element_calls}) | {card}")
    if counts != (vector_calls + element_calls, element_calls):
        raise AssertionError(f"LN forward edges: launch counters {counts}")
    worst = max(rows_out, key=lambda r: r["max_abs_err"] / r["tol"])
    return dict(rows=rows_out, worst=worst, launches=counts[0], per_element_launches=counts[1])


def kernel_phase_layernorm_bwd(card, rows_out, cases=None):
    """The backward kernel on the output and rstd of the forward kernel, as
    the training path calls it. dx within the forward's share of its scale;
    dscale/dbias (fp32 sums over all rows, in another order) within 1e-4 of
    theirs. Library: aten's native_layer_norm_backward on the same input.
    `cases`: [(batch, (rows, n, what), dtypes)], by default every
    pretraining shape and the finetune batch's pv rows."""
    from k3m_tpu_torch.kernels import layernorm_bwd, layernorm_bwd_plain
    from k3m_tpu_torch.kernels.layernorm import _forward
    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(3)
    if cases is None:
        # every shape of the pretraining batch; at the finetune batch the
        # pv rows in bf16, the summary's row
        cases = [(TRAIN_BATCH, shape, (f32, torch.bfloat16))
                 for shape in ln_shapes(TRAIN_BATCH)]
        cases.append((FT_BATCH, ln_shapes(FT_BATCH)[1], (torch.bfloat16,)))
    for batch, (rows, n, what), dtypes in cases:
        for with_res in (False, True):
            for dt in dtypes:
                x = (torch.randn(rows, n, generator=g, device="cuda") * 2 + 1).to(dt)
                res = torch.randn(rows, n, generator=g, device="cuda").to(dt) \
                    if with_res else None
                scale = torch.randn(n, generator=g, device="cuda")
                bias = torch.randn(n, generator=g, device="cuda")
                y, rstd = _forward(x, scale, bias, res, 1e-12, dt, True)
                dy = torch.randn(rows, n, generator=g, device="cuda").to(dt)
                got = layernorm_bwd(y, rstd, scale, bias, dy, dt)
                want = layernorm_bwd_plain(y, rstd, scale, bias, dy, dt)
                torch.cuda.synchronize()
                err, tol = _worst([(max_err(got[0], want[0]), tolerance(want[0], dt))]
                                  + [(max_err(a, b), 1e-4 * max(1.0, float(b.abs().max())))
                                     for a, b in zip(got[1:], want[1:])])
                xin = (x.float() + res.float()).to(dt) if with_res else x
                w, b = scale.to(dt), bias.to(dt)
                _, mean, rstd_l = torch.ops.aten.native_layer_norm(xin, [n], w, b, 1e-12)
                lib = graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, xin, [n], mean, rstd_l, w, b, [True, True, True]))
                if what == "pv" and not with_res and batch == TRAIN_BATCH:
                    _same_twice("layernorm_bwd", f"[{rows},{n}] {_dt_name(dt)}", got,
                                lambda: layernorm_bwd(y, rstd, scale, bias, dy, dt), card)
                esz = y.element_size()
                bound, by = _bound(3 * rows * n * esz + 4 * rows + 16 * n, 16 * rows * n, f32)
                _record(rows_out, card, kernel="layernorm_bwd", shape=f"[{rows},{n}] {what}",
                        batch=batch, residual=with_res, dtype=_dt_name(dt),
                        max_abs_err=err, tol=tol,
                        ms=graph_ms(lambda: layernorm_bwd(y, rstd, scale, bias, dy, dt)),
                        plain_ms=graph_ms(lambda: layernorm_bwd_plain(y, rstd, scale, bias,
                                                                      dy, dt), PLAIN_ITERS, 1),
                        library_ms=lib, bound_ms=bound, bound_by=by)


def _same_twice(kernel, what, first, run, card):
    """Determinism: a second call on the same inputs gives the same bits."""
    second = run()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"determinism {kernel} {what}: second call bit-identical {same} | {card}")
    if not same:
        raise AssertionError(f"{kernel} {what}: two calls on the same inputs differ")


def _check_lse(kernel, what, lse, q, k, bias, card):
    """The forward's row log-sum-exp against attention_lse_plain: each
    element within 1e-5 of max(1, |lse|) (fp32 statistics on both sides,
    sums in another order)."""
    from k3m_tpu_torch.kernels import attention_lse_plain
    ref = attention_lse_plain(q, k, bias)
    ratio = float(((lse - ref).abs() / (1e-5 * ref.abs().clamp(min=1.0))).max())
    log(f"lse {kernel} {what}: worst error / tolerance {ratio:.3e} | {card}")
    if not ratio <= 1.0:
        raise AssertionError(f"{kernel} {what}: lse disagrees ({ratio} of its tolerance)")
    return ratio


def _words_to_mask(words, lk):
    """bool [B, H, Lq, Lk] of a forward's mask words (bit k % 32 of word
    k // 32 keeps (q, k))."""
    bits = torch.arange(32, device=words.device, dtype=torch.int32)
    mask = ((words[..., None] >> bits) & 1).bool()
    return mask.reshape(*words.shape[:-1], -1)[..., :lk]


def _check_words(kernel, what, words, keep, card):
    """The mask words a forward keeps for its backward against
    philox_keep_mask_plain, bit for bit."""
    bad = int((_words_to_mask(words, keep.shape[-1]) != keep).sum())
    log(f"keep words {kernel} {what}: {keep.numel()} bits, {bad} differ from "
        f"philox_keep_mask_plain | {card}")
    if bad:
        raise AssertionError(f"{kernel} {what}: {bad} mask bits differ")


def _qkv(B, L, H, D, dtype, g):
    """q, k, v as strided [B, L, H, D] views of one packed projection, as a
    fused QKV layout would give them; exercises the kernels' strides."""
    qkv = torch.randn(B, L, 3, H, D, generator=g, device="cuda").to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _ragged_bias(B, L, g):
    lengths = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
    lengths[0] = L
    keep = torch.arange(L, device="cuda")[None, :] < lengths[:, None]
    return (1.0 - keep.float()) * -10000.0


def _attn_ops(B, H, Lq, Lk, D):
    return 4 * B * H * Lq * Lk * D


def _sdpa(q, k, v, bias, rate):
    import torch.nn.functional as F
    t = lambda x: x.transpose(1, 2)
    return F.scaled_dot_product_attention(t(q), t(k), t(v), dropout_p=rate,
                                          attn_mask=bias[:, None, None, :].to(q.dtype))


def _sdpa_bwd_ms(dirs, rate):
    """Device ms of SDPA's backward (via autograd) over the given
    directions [(q, k, v, bias, dout)]: forward + backward minus forward,
    each captured in CUDA graphs as the kernels are timed."""
    leaves = [[t.detach().requires_grad_() for t in d[:3]] + list(d[3:]) for d in dirs]

    def fwd():
        return [_sdpa(q, k, v, b, rate) for q, k, v, b, _ in leaves]

    def fwd_bwd():
        outs = fwd()
        torch.autograd.grad(outs, [t for d in leaves for t in d[:3]],
                            [d[4].transpose(1, 2) for d in leaves])
    return max(graph_ms(fwd_bwd, iters=5) - graph_ms(fwd, iters=5), 0.0)


ATTN_SHAPES = ((12, 50, 64, "title"), (12, 256, 64, "pv"), (8, 37, 128, "image"))
BIATTN_SHAPES = ((37, 50, 128, "c_layer"), (37, 256, 128, "c_layer_pv_v"),
                 (256, 50, 96, "c_layer_pv_t"))


def _head_key(H, key):
    """(head0, heads_global) of a shape entry's optional tail: a model
    rank's H heads among the layer's (tensor parallelism), else all H."""
    return tuple(key) if key else (0, H)


def _keep_mask(seed, B, H, Lq, Lk, rate, salt, key, tag):
    """The plain Philox keep mask of heads head0 .. head0 + H - 1 of
    heads_global (`key`); for a model rank's heads, also held bit for bit
    to that slice of the whole layer's mask."""
    from k3m_tpu_torch.kernels import philox_keep_mask_plain
    if not rate:
        return None
    h0, hg = key
    keep = philox_keep_mask_plain(seed, B, H, Lq, Lk, rate, salt, "cuda", head0=h0,
                                  heads_global=hg)
    if hg != H:
        whole = philox_keep_mask_plain(seed, B, hg, Lq, Lk, rate, salt, "cuda")
        if not torch.equal(keep, whole[:, h0:h0 + H]):
            raise AssertionError(f"{tag}: the mask of heads {h0}..{h0 + H - 1} of {hg} is "
                                 "not that slice of the layer's mask")
        del whole
    return keep


def _key_tag(H, key):
    h0, hg = key
    return "" if hg == H else f" heads {h0}-{h0 + H - 1} of {hg}"


def kernel_phase_attention(card, rows_out, cases=None, shapes=ATTN_SHAPES, qkv=_qkv):
    """The forward kernel against attention_plain for each (batch, dtype,
    rate) of `cases` (by default attention_cases of every main-path batch)
    at each (heads, length, D[, head0, heads_global]) of `shapes`: a tail
    places the H heads among the layer's, as a model rank runs them under
    tensor parallelism. `qkv(B, L, H, D, dtype, generator)` makes the
    operands (views of one projection)."""
    from k3m_tpu_torch.kernels import attention_plain, fused_attention
    from k3m_tpu_torch.kernels.attention import _forward
    g = torch.Generator(device="cuda").manual_seed(1)
    if cases is None:
        cases = list(attention_cases(FWD_BATCHES + (FT_BATCH,)))
    for B, dt, rate in cases:
        for H, L, D, what, *key in shapes:
            key = _head_key(H, key)
            kw = dict(head0=key[0], heads_global=key[1])
            q, k, v = qkv(B, L, H, D, dt, g)
            bias = _ragged_bias(B, L, g)
            seed = 11
            tag = f"B{B} L{L} D{D} {_dt_name(dt)} rate {rate}{_key_tag(H, key)}"
            keep = _keep_mask(seed, B, H, L, L, rate, 0, key, tag)
            out = fused_attention(q, k, v, bias, dropout_rate=rate, seed=seed, **kw)
            ref = attention_plain(q, k, v, bias, keep, rate)
            out_l, lse, words = _forward(q, k, v, bias, rate, seed, for_backward=True, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out, out_l):
                raise AssertionError(f"fused_attention {what}: keeping lse and the mask "
                                     "changed the output")
            lse_ratio = _check_lse("fused_attention", tag, lse, q, k, bias, card)
            if words is not None:
                _check_words("fused_attention", tag, words, keep, card)
            bound, by = _bound(4 * B * L * H * D * q.element_size() + B * L * 4,
                               _attn_ops(B, H, L, L, D), dt)
            # timed as its path calls it: training (B96, B32, the packed
            # image stack's B192) keeps lse and the mask words for the
            # backward, serving (B64) keeps nothing
            train = B in TRAINING_BATCHES + (PACKED_IMAGE_BATCH,)
            _record(rows_out, card, kernel="fused_attention", batch=B,
                    shape=f"B{B} H{H} L{L} D{D} {what}{_key_tag(H, key)}", dtype=_dt_name(dt),
                    rate=rate, max_abs_err=max_err(out, ref), tol=tolerance(ref, dt),
                    ms=graph_ms(lambda: _forward(q, k, v, bias, rate, seed,
                                                 for_backward=train, **kw)),
                    timed_for_backward=train,
                    plain_ms=graph_ms(lambda: attention_plain(q, k, v, bias, keep, rate),
                                      PLAIN_ITERS, 1),
                    library_ms=graph_ms(lambda: _sdpa(q, k, v, bias, rate)),
                    bound_ms=bound, bound_by=by, lse_err_ratio=lse_ratio)


EDGE_LENGTHS = (1, 16, 37, 50, 64, 65, 129, 256)
EDGE_BI = ((37, 50), (37, 256), (256, 50), (1, 65))


def _edge_check(kernel, tag, got, want, lses, kept, dt):
    """One edge case: the output(s) within the forward's tolerance, each
    direction's lse within 1e-5 of max(1, |lse|) of attention_lse_plain,
    its mask words bit for bit those of philox_keep_mask_plain; returns the
    output's error / tolerance."""
    from k3m_tpu_torch.kernels import attention_lse_plain
    ratio = max(max_err(a, r) / tolerance(r, dt) for a, r in zip(got, want))
    if not ratio <= 1.0:
        raise AssertionError(f"{kernel} {tag} disagrees: {ratio} of its tolerance")
    for lse, (q, k, b) in lses:
        ref = attention_lse_plain(q, k, b)
        if not bool(((lse - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all()):
            raise AssertionError(f"{kernel} {tag}: lse disagrees")
    for words, keep in kept:
        if not torch.equal(_words_to_mask(words, keep.shape[-1]), keep):
            raise AssertionError(f"{kernel} {tag}: mask words differ")
    return ratio


def forward_edge_check(card):
    """The forward kernels at the edges of their tiles, B 2, H 3, in fp32
    and bf16 at rate 0 and 0.1, q/k/v strided views of packed projections:
    the self-attention kernel at every Lq x Lk over EDGE_LENGTHS (one query
    row; one key; a key tile and one more; a 64-row CTA and one more row;
    8-warp CTAs at D 64) with D 64, 96 and 128, and the bi-attention kernel
    at EDGE_BI with the same D (warps of padding rows, n-blocks past Lk, the
    long direction first)."""
    from k3m_tpu_torch.kernels import attention, attention_plain, biattention_plain, coattn, \
        philox_keep_mask_plain
    g = torch.Generator(device="cuda").manual_seed(5)
    B, H, seed = 2, 3, 23
    worst, cases = 0.0, 0
    for D in (64, 96, 128):
        for dt in (torch.float32, torch.bfloat16):
            for Lq in EDGE_LENGTHS:
                for Lk in EDGE_LENGTHS:
                    q = _qkv(B, Lq, H, D, dt, g)[0]
                    k, v = _qkv(B, Lk, H, D, dt, g)[1:]
                    bias = _ragged_bias(B, Lk, g)
                    for rate in RATES:
                        keep = philox_keep_mask_plain(seed, B, H, Lq, Lk, rate, 0, "cuda") \
                            if rate else None
                        out, lse, words = attention._forward(q, k, v, bias, rate, seed,
                                                             for_backward=True)
                        worst = max(worst, _edge_check(
                            "fused_attention", f"Lq{Lq} Lk{Lk} D{D} {_dt_name(dt)} rate {rate}",
                            [out], [attention_plain(q, k, v, bias, keep, rate)],
                            [(lse, (q, k, bias))], [(words, keep)] if rate else [], dt))
                        cases += 1
            for L1, L2 in EDGE_BI:
                q1, k1, v1 = _qkv(B, L1, H, D, dt, g)
                q2, k2, v2 = _qkv(B, L2, H, D, dt, g)
                b1, b2 = _ragged_bias(B, L1, g), _ragged_bias(B, L2, g)
                args = (q1, k1, v1, b1, q2, k2, v2, b2)
                for rate in RATES:
                    m1 = philox_keep_mask_plain(seed, B, H, L2, L1, rate, 0, "cuda") \
                        if rate else None
                    m2 = philox_keep_mask_plain(seed, B, H, L1, L2, rate, 7919, "cuda") \
                        if rate else None
                    c1, c2, (lse1, w1), (lse2, w2) = coattn._forward(*args, rate, rate, seed,
                                                                     for_backward=True)
                    worst = max(worst, _edge_check(
                        "fused_biattention", f"L{L1}<->{L2} D{D} {_dt_name(dt)} rate {rate}",
                        [c1, c2], biattention_plain(*args, m1, m2, rate, rate),
                        [(lse1, (q2, k1, b1)), (lse2, (q1, k2, b2))],
                        [(w1, m1), (w2, m2)] if rate else [], dt))
                    cases += 1
    torch.cuda.synchronize()
    log(f"forward edges: {cases} cases of both forward kernels agree with their plain "
        f"versions (worst error / tolerance {worst:.3e}), lse and mask words too | {card}")
    return dict(cases=cases, worst_ratio=worst)


def kernel_phase_biattention(card, rows_out, cases=None, shapes=BIATTN_SHAPES, heads=8):
    """The bi-attention kernel against biattention_plain, as
    kernel_phase_attention, at each (L1, L2, D[, head0, heads_global]) of
    `shapes` (`heads` heads)."""
    from k3m_tpu_torch.kernels import biattention_plain, fused_biattention
    from k3m_tpu_torch.kernels.coattn import _forward
    g = torch.Generator(device="cuda").manual_seed(2)
    H = heads
    if cases is None:
        cases = list(attention_cases(FWD_BATCHES + (FT_BATCH,)))
    for B, dt, rate in cases:
        for L1, L2, D, what, *key in shapes:
            key = _head_key(H, key)
            kw = dict(head0=key[0], heads_global=key[1])
            q1, k1, v1 = _qkv(B, L1, H, D, dt, g)
            q2, k2, v2 = _qkv(B, L2, H, D, dt, g)
            b1, b2 = _ragged_bias(B, L1, g), _ragged_bias(B, L2, g)
            args = (q1, k1, v1, b1, q2, k2, v2, b2)
            seed = 13
            tag = f"B{B} L{L1}<->{L2} D{D} {_dt_name(dt)} rate {rate}{_key_tag(H, key)}"
            m1 = _keep_mask(seed, B, H, L2, L1, rate, 0, key, tag)
            m2 = _keep_mask(seed, B, H, L1, L2, rate, 7919, key, tag)
            drop = dict(dropout1=rate, dropout2=rate, seed=seed, **kw)
            c1, c2 = fused_biattention(*args, **drop)
            r1, r2 = biattention_plain(*args, m1, m2, rate, rate)
            l_c1, l_c2, (lse1, w1), (lse2, w2) = _forward(*args, rate, rate, seed,
                                                          for_backward=True, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(c1, l_c1) and torch.equal(c2, l_c2)):
                raise AssertionError(f"fused_biattention {what}: keeping lse and the mask "
                                     "changed the output")
            lse_ratio = max(
                _check_lse("fused_biattention direction 1", tag, lse1, q2, k1, b1, card),
                _check_lse("fused_biattention direction 2", tag, lse2, q1, k2, b2, card))
            if w1 is not None:
                _check_words("fused_biattention direction 1", tag, w1, m1, card)
                _check_words("fused_biattention direction 2", tag, w2, m2, card)
            bound, by = _bound(4 * B * (L1 + L2) * H * D * q1.element_size()
                               + B * (L1 + L2) * 4, 2 * _attn_ops(B, H, L1, L2, D), dt)

            def two_sdpa():
                _sdpa(q2, k1, v1, b1, rate)
                _sdpa(q1, k2, v2, b2, rate)
            train = B in TRAINING_BATCHES      # timed as its path calls it
            _record(rows_out, card, kernel="fused_biattention", batch=B,
                    shape=f"B{B} H{H} L{L1}<->{L2} D{D} {what}{_key_tag(H, key)}",
                    dtype=_dt_name(dt),
                    rate=rate, max_abs_err=max(max_err(c1, r1), max_err(c2, r2)),
                    tol=min(tolerance(r1, dt), tolerance(r2, dt)),
                    ms=graph_ms(lambda: _forward(*args, rate, rate, seed,
                                                 for_backward=train, **kw)),
                    timed_for_backward=train,
                    plain_ms=graph_ms(lambda: biattention_plain(*args, m1, m2, rate, rate),
                                      PLAIN_ITERS, 1),
                    library_ms=None, two_sdpa_ms=graph_ms(two_sdpa),
                    bound_ms=bound, bound_by=by, lse_err_ratio=lse_ratio)


def bwd_errors(got, ref, dtype):
    """(error, tolerance) [B, H] of a [B, L, H, D] gradient. Each (batch,
    head) is held to a share of its own largest magnitude, because rows of
    few keys give gradients ten to a hundred times those of full rows, and
    a limit from the whole tensor would pass a wrong full row. fp32: 1e-4
    (the kernel sums in another order); bf16: the forward's 2^-6, two bf16
    ulps of the largest value (inputs bf16 on both sides and sums fp32; the
    kernel rounds dS and the dropped P to bf16 for the tensor cores, then
    each output once). A head's scale is at least a floor share of the
    tensor's largest magnitude, for gradients that are zero or small in
    exact arithmetic (rows of one to three keys, where dS = P (dP -
    rowsum(dP P)) cancels and the rounding of dP remains): 1e-2 in fp32
    (seen: 1.8e-6 where the largest value is ~14), 1e-3 in bf16."""
    ref = ref.float()
    share, floor = (1e-4, 1e-2) if dtype == torch.float32 else (2.0 ** -6, 1e-3)
    scale = ref.abs().amax(dim=(1, 3)).clamp(min=floor * float(ref.abs().max()))
    return (got.float() - ref).abs().amax(dim=(1, 3)), share * scale


def bwd_worst(got, ref, dtype):
    """(error, tolerance) of the (batch, head) closest to its limit."""
    err, tol = bwd_errors(got, ref, dtype)
    i = int((err / tol).argmax())
    return float(err.flatten()[i]), float(tol.flatten()[i])


BWD_TILE = 64      # keys per CTA of the bf16 dK/dV kernel (mma_util.cuh kMmaBQ)


def _forward_kept(ops_, rate, seed):
    """What the forward kernel keeps for the backward of each direction of
    `ops_`, as the training path saves it: (output, lse, keep words or
    None); the self-attention kernel for one direction, the bi-attention
    kernel for two."""
    from k3m_tpu_torch.kernels import attention, coattn
    h0, hg = ops_[0][10:12]
    if len(ops_) == 1:
        q, k, v, b = ops_[0][:4]
        return [attention._forward(q, k, v, b, rate, seed, for_backward=True, head0=h0,
                                   heads_global=hg)]
    (q2, k1, v1, b1), (q1, k2, v2, b2) = (o[:4] for o in ops_)
    c1, c2, kept1, kept2 = coattn._forward(q1, k1, v1, b1, q2, k2, v2, b2, rate, rate,
                                           seed, for_backward=True, head0=h0,
                                           heads_global=hg)
    return [(c1, *kept1), (c2, *kept2)]


def planted_faults(ops_, fwd, got, rate, seed, dt):
    """Error/tolerance ratios of faults the tolerance must reject, each
    above 1, read on batch element 0 alone, whose rows hold every key
    (_ragged_bias), so that a short row's large gradient cannot be what
    rejects them: the kernel run under a wrong mask (the mask words of a
    forward with another seed); dV without
    the 1 / (1 - rate) of the kept probabilities; dV zero past the first
    tile of keys (where Lk has more than one)."""
    from k3m_tpu_torch.kernels import attention_bwd, attention_bwd_plain, \
        philox_keep_mask_plain

    def ratio(a, r):
        err, tol = bwd_errors(a, r, dt)
        return float((err[0] / tol[0]).max())

    faults = {"wrong mask": [], "dV without 1/(1-rate)": [], "dV zero past tile 1": []}
    wrong = _forward_kept(ops_, rate, seed + 1)
    for (q, k, v, b, do, salt, H, Lq, Lk, D, h0, hg), (out, lse, _), (_, _, other), \
            (dq, dk, dv) in zip(ops_, fwd, wrong, got):
        keep = philox_keep_mask_plain(seed, q.shape[0], H, Lq, Lk, rate, salt, "cuda",
                                      head0=h0, heads_global=hg)
        want = attention_bwd_plain(q, k, v, b, do, keep, rate)
        bad = attention_bwd(q, k, v, b, out, lse, other, do, rate)
        faults["wrong mask"].append(max(ratio(a, r) for a, r in zip(bad, want)))
        faults["dV without 1/(1-rate)"].append(ratio(dv * (1 - rate), want[2]))
        if Lk > BWD_TILE:
            cut = dv.clone()
            cut[:, BWD_TILE:] = 0
            faults["dV zero past tile 1"].append(ratio(cut, want[2]))
    ratios = {name: max(r) for name, r in faults.items() if r}
    for name, r in ratios.items():
        if not r > 1.0:
            raise AssertionError(f"attention_bwd tolerance passes a planted fault: {name} "
                                 f"(error/tolerance {r})")
    return ratios


def _attn_bwd_bytes(ops_, fwd):
    """Bytes the backward function must move (its bound): q, k, v, dO and
    the fp32 bias read, dq, dk, dv written, as the TPU kernel takes them;
    where `fwd` is given, also what this design reads of the forward's (O,
    fp32 lse, the mask words), which a backward that recomputes lse and the
    mask and sums rowsum(dP P) itself does not need."""
    total = 0
    for i, (q, k, v, b, do, salt, H, Lq, Lk, D, *_) in enumerate(ops_):
        e = q.element_size()
        total += 3 * q.shape[0] * Lq * H * D * e + 4 * q.shape[0] * Lk * H * D * e \
            + q.shape[0] * Lk * 4
        if fwd is not None:
            total += sum(t.numel() * t.element_size() for t in fwd[i] if t is not None)
    return total


def kernel_phase_attention_bwd(card, rows_out, runs=None, attn_shapes=ATTN_SHAPES,
                               bi_shapes=BIATTN_SHAPES, bi_heads=8, qkv=_qkv):
    """The backward kernel for each self-attention shape and, once per
    direction, each co-attention shape, at rate 0 and 0.1 (under the plain
    version's Philox mask), at the pretraining batch (and in bf16 at rate
    0.1 at the finetune batch), fed the forward kernel's
    output and lse as the training path feeds it; at rate 0.1 the tolerance
    must also reject the planted faults, and at the heaviest shape two calls
    must give the same bits. The backward reads what the forward kernel
    keeps for it (output, lse, mask words), as on the training path;
    times are of the backward alone. `runs`: [(batch, dtypes, rates)], by
    default the pretraining batch in fp32 and bf16 at both rates and the
    finetune batch as its training calls it (bf16, rate 0.1). Shapes as
    kernel_phase_attention's and kernel_phase_biattention's (`bi_heads`
    heads), a head0/heads_global tail included; `qkv` as there (the
    self-attention directions' operands)."""
    from k3m_tpu_torch.kernels import attention_bwd, attention_bwd_plain
    g = torch.Generator(device="cuda").manual_seed(4)
    if runs is None:
        runs = ((TRAIN_BATCH, (torch.float32, torch.bfloat16), RATES),
                (FT_BATCH, (torch.bfloat16,), (0.1,)))
    for B, dtypes, rates in runs:
        cases = [(f"B{B} H{H} L{L} D{D} {what}{_key_tag(H, _head_key(H, key))}",
                  [(H, L, L, D, 0, *_head_key(H, key))])
                 for H, L, D, what, *key in attn_shapes]
        Hb = bi_heads
        cases += [(f"B{B} H{Hb} L{L1}<->{L2} D{D} {what}{_key_tag(Hb, _head_key(Hb, key))}",
                   [(Hb, L2, L1, D, 0, *_head_key(Hb, key)),
                    (Hb, L1, L2, D, 7919, *_head_key(Hb, key))])
                  for L1, L2, D, what, *key in bi_shapes]
        for shape, dirs in cases:
            for dt in dtypes:
                ops_ = []
                make = qkv if len(dirs) == 1 else _qkv
                for H, Lq, Lk, D, salt, h0, hg in dirs:
                    q = make(B, Lq, H, D, dt, g)[0]
                    k, v = make(B, Lk, H, D, dt, g)[1:]
                    do = torch.randn(B, Lq, H, D, generator=g, device="cuda").to(dt)
                    ops_.append((q, k, v, _ragged_bias(B, Lk, g), do, salt, H, Lq, Lk, D,
                                 h0, hg))
                for rate in rates:
                    seed = 17
                    fwd = _forward_kept(ops_, rate, seed)
                    keeps = [_keep_mask(seed, B, H, Lq, Lk, rate, salt, (h0, hg), shape)
                             for q, k, v, b, do, salt, H, Lq, Lk, D, h0, hg in ops_]

                    def kernel():
                        return [attention_bwd(q, k, v, b, out, lse, words, do, rate)
                                for (q, k, v, b, do, *_), (out, lse, words) in zip(ops_, fwd)]

                    def plain():
                        return [attention_bwd_plain(q, k, v, b, do, keep, rate)
                                for (q, k, v, b, do, *_), keep in zip(ops_, keeps)]
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    err, tol = _worst([bwd_worst(a, r, dt)
                                       for gs, ws in zip(got, want) for a, r in zip(gs, ws)])
                    faults = planted_faults(ops_, fwd, got, rate, seed, dt) if rate else None
                    if "L256 D64" in shape and rate:
                        _same_twice("attention_bwd", f"{shape} {_dt_name(dt)} rate {rate}",
                                    [t for gs in got for t in gs],
                                    lambda: [t for gs in kernel() for t in gs], card)
                    ops = sum(5 * 2 * B * H * Lq * Lk * D
                              for *_, H, Lq, Lk, D, h0, hg in ops_)
                    bound, by = _bound(_attn_bwd_bytes(ops_, None), ops, dt)
                    design_bound, _ = _bound(_attn_bwd_bytes(ops_, fwd), ops, dt)
                    if faults:
                        log(f"attention_bwd {shape} {_dt_name(dt)}: planted faults rejected, "
                            f"error/tolerance {faults}")
                    _record(rows_out, card, kernel="attention_bwd", shape=shape, batch=B,
                            dtype=_dt_name(dt), rate=rate, directions=len(ops_),
                            max_abs_err=err, tol=tol, planted_faults=faults,
                            ms=graph_ms(kernel), plain_ms=graph_ms(plain, PLAIN_ITERS, 1),
                            library_ms=_sdpa_bwd_ms([o[:5] for o in ops_], rate),
                            bound_ms=bound, bound_by=by, design_bound_ms=design_bound)
                    del fwd, got, want


def dropout_mask_check(card, B):
    """Read the forward kernels' dropout masks back at main-path shapes and
    hold them to philox_keep_mask_plain bit for bit: with q = k = 0 and v
    the one-hot rows of the identity over a window of D keys (the others
    masked by the bias), output column d of query q is keep(q, k0 + d) / D
    * scale, positive exactly where the kernel kept. Self-attention at the
    pv shape (salt 0) and both directions of c_layer_pv_t (salts 0, 7919),
    bf16 (the tensor-core tile of the main path); then the keep rate of all
    draws against 0.9 within 4 sigma. At batch B (the pretraining and the
    finetune batch)."""
    from k3m_tpu_torch.kernels import fused_attention, fused_biattention, \
        philox_keep_mask_plain
    rate, seed = 0.1, 77
    bf16 = torch.bfloat16

    def windows(Lq, Lk, H, D):
        for k0 in range(0, Lk, D):
            n = min(D, Lk - k0)
            v = torch.zeros(B, Lk, H, D, device="cuda", dtype=bf16)
            v[:, k0:k0 + n] = torch.eye(D, device="cuda", dtype=bf16)[:n, None, :]
            bias = torch.full((B, Lk), -10000.0, device="cuda")
            bias[:, k0:k0 + n] = 0.0
            yield k0, n, v, bias

    def read(out, k0, n, mask):
        mask[..., k0:k0 + n] = (out.float() > 0).permute(0, 2, 1, 3)[..., :n]

    results = {}
    H, L, D = 12, 256, 64
    zeros = torch.zeros(B, L, H, D, device="cuda", dtype=bf16)
    got = torch.empty(B, H, L, L, dtype=torch.bool, device="cuda")
    for k0, n, v, bias in windows(L, L, H, D):
        read(fused_attention(zeros, zeros, v, bias, dropout_rate=rate, seed=seed), k0, n, got)
    results["self L256 D64"] = (got, philox_keep_mask_plain(seed, B, H, L, L, rate, 0, "cuda"))
    H, L1, L2, D = 8, 256, 50, 96
    z1 = torch.zeros(B, L1, H, D, device="cuda", dtype=bf16)
    z2 = torch.zeros(B, L2, H, D, device="cuda", dtype=bf16)
    got1 = torch.empty(B, H, L2, L1, dtype=torch.bool, device="cuda")
    got2 = torch.empty(B, H, L1, L2, dtype=torch.bool, device="cuda")
    (_, _, v2, bias2), = windows(L1, L2, H, D)
    for k0, n, v1, bias1 in windows(L2, L1, H, D):
        c1, c2 = fused_biattention(z1, z1, v1, bias1, z2, z2, v2, bias2, dropout1=rate,
                                   dropout2=rate, seed=seed)
        read(c1, k0, n, got1)
    read(c2, 0, L2, got2)
    results["bi 50<-256 D96 direction 1"] = (
        got1, philox_keep_mask_plain(seed, B, H, L2, L1, rate, 0, "cuda"))
    results["bi 256<-50 D96 direction 2"] = (
        got2, philox_keep_mask_plain(seed, B, H, L1, L2, rate, 7919, "cuda"))
    torch.cuda.synchronize()
    kept = draws = 0
    for name, (a, b) in results.items():
        bad = int((a != b).sum())
        log(f"dropout mask B{B} {name}: {a.numel()} draws, {bad} differ from "
            f"philox_keep_mask_plain | {card}")
        if bad:
            raise AssertionError(f"dropout mask {name}: {bad} bits differ")
        kept += int(a.sum())
        draws += a.numel()
    share = kept / draws
    sigma = math.sqrt(0.9 * 0.1 / draws)
    log(f"dropout keep rate B{B} {share:.6f} over {draws} draws; 0.9 +- 4 sigma = "
        f"+-{4 * sigma:.2e} | {card}")
    if not (draws >= 10 ** 6 and abs(share - 0.9) <= 4 * sigma):
        raise AssertionError(f"keep rate {share} outside 4 sigma of 0.9")
    return dict(draws=draws, keep_rate=share, sigma=sigma)


def launch_overhead(card, n=2000):
    """Host microseconds per call of the LN wrapper (ctypes launch) and of
    F.layer_norm on a [64, 768] fp32 tensor: both enqueue a ~2 us kernel,
    so the loop is bound by the host's cost of one call."""
    import torch.nn.functional as F

    from k3m_tpu_torch.kernels import fused_layernorm
    x = torch.randn(64, 768, device="cuda")
    s = torch.ones(768, device="cuda")
    out = {}
    for name, fn in (("fused_layernorm", lambda: fused_layernorm(x, s, s)),
                     ("F.layer_norm", lambda: F.layer_norm(x, (768,), s, s, 1e-12))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
    log(f"host cost per call: fused_layernorm {out['fused_layernorm']:.2f} us, "
        f"F.layer_norm {out['F.layer_norm']:.2f} us | {card}")
    return out


# ------------------------------------------- the MoE's per-pair kernels

# pretrain-dsv2lite-ep8-b16's MoE layer: 16 x 612 packed rows, top 6 of 64
# routed experts, 8 held, hidden 2,048, experts of 1,408
MOE_CELL = dict(N=16 * 612, E=64, k=6, H=2048, I=1408, held=(0, 8), shapes=((16, 612),))
MOE_CASES = ("range", "every", "none", "one", "dropped")
MOE_LAYER_LAUNCHES = dict(moe_gather=2, swiglu_fwd=2, swiglu_bwd=1, moe_combine_fwd=1,
                          moe_combine_bwd=1, moe_gather_sum=1)


def _moe_routes(case, dev):
    """((e0, e1), route's tok, inv, offs, valid) of a case: `range` the
    cell's held 8 of 64, `every` all 64 held, `none` no pair held, `one`
    expert e0 in every row, `dropped` valid cleared for e0's rows (the
    benchmark's planted fault); the same draws as tests/test_torch_moe_kernels.py."""
    c = MOE_CELL
    from k3m_tpu_torch.model import deepseek as ds
    N, E, k = c["N"], c["E"], c["k"]
    e0, e1 = (0, E) if case == "every" else c["held"]
    g = torch.Generator().manual_seed(0)
    outside = torch.tensor([e for e in range(E) if not e0 <= e < e1])

    def choose(pool, m):
        return pool[torch.rand(N, pool.numel(), generator=g).argsort(-1)[:, :m]]
    if case == "none":
        idx = choose(outside, k)
    elif case == "one":
        idx = torch.cat([torch.full((N, 1), e0), choose(outside, k - 1)], dim=1)
    else:
        idx = choose(torch.arange(E), k)
    tok, inv, offs, valid, _ = ds.route(idx.to(dev), e0, e1)
    if case == "dropped":
        valid = valid & (torch.arange(valid.numel(), device=dev) >= offs[0])
    return (e0, e1), tok, inv, offs, valid


def _moe_err(got, want, share=2.0 ** -7, floor=1e-3):
    """(error, tolerance) under the test file's elementwise limit |got -
    want| <= share |want| + floor max|want|: the error is the largest
    excess over the share's part; share 0 and floor 0 ask for the same bits."""
    got, want = got.float(), want.float()
    if not want.numel():
        return 0.0, 0.0
    err = float(((got - want).abs() - share * want.abs()).max().clamp_min(0))
    return err, floor * float(want.abs().max())


def _moe_bytes(n, R):
    """Each kernel's least bytes at n held pairs: the held rows read once
    and written once, indices, masks and weights included."""
    c = MOE_CELL
    N, k, H, I = c["N"], c["k"], c["H"], c["I"]
    idx_b, pair_b = n * 9, N * k * 12     # tok/inv and valid a held row; inv and w a pair
    return dict(moe_gather=2 * n * H * 2 + idx_b, swiglu_fwd=3 * n * I * 2,
                swiglu_bwd=5 * n * I * 2, moe_combine_fwd=(n + N) * H * 2 + pair_b,
                moe_combine_bwd=(N + 2 * n) * H * 2 + pair_b + N * k * 4,
                moe_gather_sum=(n + N) * H * 2 + N * k * 8)


def moe_kernel_rows(card):
    """The six per-pair kernels of kernels/moe.py on the card at the
    DeepSeek-V2-Lite cell's shapes (MOE_CELL): each held against its plain
    version on each case (_moe_routes) at the limits of
    tests/test_torch_moe_kernels.py (the gather and dy's held rows bit for
    bit, the rest within 2^-7 of each element plus 1e-3 of the scale, dw
    within 1e-4 plus 1e-4), one launch each; on the cell's case each timed
    (a graph of calls rotating over copies of the inputs past twice the L2)
    beside the plain version and its byte bound. Then one MoE layer at the
    cell's widths, forward and backward: the kernels' launch counts
    (MOE_LAYER_LAUNCHES), its outputs and gradients against the layer on
    the plain versions within 2^-6 of their scale, and the held experts'
    forward and backward (`_HeldExperts`) and the whole layer's, timed on
    the kernels and on the plain versions."""
    from k3m_tpu_torch.kernels import moe
    c, dev, bf = MOE_CELL, torch.device("cuda"), torch.bfloat16
    N, k, H, I = c["N"], c["k"], c["H"], c["I"]
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    rows = []
    for case in MOE_CASES:
        _, tok, inv, offs, valid = _moe_routes(case, dev)
        R, n = valid.numel(), int(offs[-1])
        u, h, da, y, dout = rand(N, H), rand(R, 2 * I), rand(R, I), rand(R, H), rand(N, H)
        w = torch.rand(N, k, generator=g, device=dev)
        calls = dict(
            moe_gather=((u, tok, offs, valid), lambda o: o[:n], (0.0, 0.0)),
            swiglu_fwd=((h, offs), lambda o: o[:n], (2.0 ** -7, 1e-3)),
            swiglu_bwd=((h, da, offs), lambda o: o[:n], (2.0 ** -7, 1e-3)),
            moe_combine_fwd=((y, inv, w, offs), lambda o: o, (2.0 ** -7, 1e-3)),
            moe_combine_bwd=((dout, y, inv, w, offs), lambda o: (o[0][:n], o[1]), None),
            moe_gather_sum=((y, inv, offs, k), lambda o: o, (2.0 ** -7, 1e-3)))
        moe.reset_launch_counts()
        checked = []
        for name, (args, held, lim) in calls.items():
            got, want = held(getattr(moe, name)(*args)), held(getattr(moe, name + "_plain")(*args))
            if lim is None:        # dy's held rows bit for bit, dw in fp32
                errs = [_moe_err(got[0], want[0], 0.0, 0.0),
                        _moe_err(got[1], want[1], 1e-4, 1e-4)]
            else:
                errs = [_moe_err(got, want, *lim)]
            err, tol = max(errs)
            checked.append(dict(kernel=name, case=case, shape=f"N{N} k{k} H{H} I{I} n{n} R{R}",
                                dtype="bfloat16", held_rows=n, capacity_rows=R,
                                max_abs_err=err, tol=tol))
            log(f"moe kernel {name} {case}: n {n} of {R}, max_abs_err {err:.3e} (tol "
                f"{tol:.1e}) | {card}")
            if not all(e <= t for e, t in errs):
                raise AssertionError(f"moe {name} {case} disagrees with its plain version: "
                                     f"{errs}")
        torch.cuda.synchronize()
        counts = moe.launch_counts()
        if counts != {name: 1 for name in moe.WRAPPERS}:
            raise AssertionError(f"moe {case}: launch counts {counts}, one each expected")
        rows += checked
        if case != "range":
            continue
        nbytes = _moe_bytes(n, R)
        for row in checked:
            name, (args, _, _) = row["kernel"], calls[row["kernel"]]
            kernel, plain = getattr(moe, name), getattr(moe, name + "_plain")
            copies = [args] + [tuple(a.clone() if torch.is_tensor(a) and a.is_floating_point()
                                     else a for a in args)
                               for _ in range(l2_copies(nbytes[name]) - 1)]
            row.update(ms=rotated_ms(kernel, copies),
                       plain_ms=cuda_ms(lambda: plain(*args), iters=PLAIN_ITERS),
                       bound_ms=1e3 * nbytes[name] / HBM_BYTES_PER_S, bound_by="bytes",
                       l2_copies=len(copies))
            row["roofline_pct"] = 100 * row["bound_ms"] / row["ms"]
            log(f"moe kernel {name} {case}: kernel_ms {row['ms']:.4f} plain_ms "
                f"{row['plain_ms']:.4f} bound_ms {row['bound_ms']:.4f} "
                f"({row['roofline_pct']:.1f} %), {len(copies)} copies | {card}")
        del u, h, da, y, dout
        torch.cuda.empty_cache()
    layer = moe_layer_check(card)
    summary = [dict(name=name, route="cuda", source="k3m_tpu_torch/kernels/csrc/moe.cu",
                    replaces="none (the JAX package has no mixture of experts)",
                    launches_per_moe_layer=layer["launches"][name],
                    max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
                    **{key: r[key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "roofline_pct")})
               for name in moe.WRAPPERS
               for r in [next(r for r in rows if r["kernel"] == name and "ms" in r)]]
    return dict(rows=rows, layer=layer, summary=summary)


def moe_layer_check(card):
    """One MoE layer at the cell's widths, forward and backward (moe_kernel_rows)."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.kernels import moe
    from k3m_tpu_torch.model import deepseek as ds
    c, dev = MOE_CELL, torch.device("cuda")
    cfg = K3MConfig(text_block="deepseek_v2", hidden_size=c["H"], num_attention_heads=16,
                    moe_intermediate_size=c["I"], n_routed_experts=c["E"],
                    num_experts_per_tok=c["k"], n_shared_experts=2, experts_held=c["held"],
                    aux_loss_alpha=0.001)
    torch.manual_seed(SEED)
    layer = ds.MoE(cfg, 1).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g, device=dev))
    shapes = c["shapes"]
    biases = tuple(torch.zeros(*shape, device=dev) for shape in shapes)
    u = torch.randn(c["N"], c["H"], generator=g, device=dev).to(torch.bfloat16)
    u.requires_grad_(True)
    dout = torch.randn(c["N"], c["H"], generator=g, device=dev).to(torch.bfloat16)
    params = [u, *layer.parameters()]

    def step():
        out = layer(u, shapes, biases)
        grads = torch.autograd.grad(out, params, dout, allow_unused=True)
        return [out.detach(), *(d for d in grads if d is not None)]

    step()                          # warm-up
    torch.cuda.synchronize()
    moe.reset_launch_counts()
    got = step()
    torch.cuda.synchronize()
    launches = moe.launch_counts()
    log(f"moe layer: kernel launches of one forward and backward {launches} | {card}")
    if launches != MOE_LAYER_LAUNCHES:
        raise AssertionError(f"moe layer: launches {launches}, expected {MOE_LAYER_LAUNCHES}")
    _, tok, inv, offs, valid = _moe_routes("range", dev)
    w13 = layer.experts.w13.detach().to(torch.bfloat16).requires_grad_(True)
    w2 = layer.experts.w2.detach().to(torch.bfloat16).requires_grad_(True)
    weights = torch.rand(c["N"], c["k"], generator=g, device=dev).requires_grad_(True)
    held_in = [u, w13, w2, weights]

    def held():
        out = ds._HeldExperts.apply(*held_in, tok, inv, offs, valid)
        torch.autograd.grad(out, held_in, dout)

    res = dict(launches=launches, held_experts_ms=cuda_ms(held, iters=10),
               layer_ms=cuda_ms(step, iters=10))
    saved = {name: getattr(ds, name) for name in moe.WRAPPERS}
    try:
        for name in moe.WRAPPERS:
            setattr(ds, name, getattr(moe, name + "_plain"))
        want = step()
        res.update(held_experts_plain_ms=cuda_ms(held, iters=5),
                   layer_plain_ms=cuda_ms(step, iters=5))
    finally:
        for name, fn in saved.items():
            setattr(ds, name, fn)
    errs = [(max_err(a, b), 2.0 ** -6 * max(float(b.float().abs().max()), 1e-30))
            for a, b in zip(got, want)]
    res["max_abs_err"], res["tol"] = _worst(errs)
    log(f"moe layer: outputs and gradients against the plain versions' worst "
        f"{res['max_abs_err']:.3e} (tol {res['tol']:.1e}); _HeldExperts forward + backward "
        f"{res['held_experts_ms']:.3f} ms (plain versions {res['held_experts_plain_ms']:.3f}), "
        f"the layer {res['layer_ms']:.3f} ms (plain versions {res['layer_plain_ms']:.3f}) "
        f"| {card}")
    if not all(e <= t for e, t in errs):
        raise AssertionError(f"moe layer disagrees with the plain versions: {errs}")
    del layer, got, want
    torch.cuda.empty_cache()
    return res


def phase_kernels(card):
    """Every part of phase 3, each part's seconds logged (`part_seconds`)."""
    rows, parts = [], {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t0
        return out
    for phase in (kernel_phase_layernorm, kernel_phase_layernorm_bwd,
                  kernel_phase_attention, kernel_phase_biattention,
                  kernel_phase_attention_bwd):
        timed(phase.__name__, phase, card, rows)
    masks = timed("dropout_mask_check", lambda: {B: dropout_mask_check(card, B)
                                                 for B in TRAINING_BATCHES})
    edges = timed("forward_edge_check", forward_edge_check, card)
    ln_edges = timed("ln_edge_rows", ln_edge_rows, card)
    host_us = timed("launch_overhead", launch_overhead, card)
    tp_rows = timed("tp_kernel_rows", tp_kernel_rows, card)
    option_rows = timed("option_kernel_rows", option_kernel_rows, card)
    packed_rows = timed("packed_kernel_rows", packed_kernel_rows, card)
    moe_rows = timed("moe_kernel_rows", moe_kernel_rows, card)
    log(f"kernels: part seconds { {k: round(v, 1) for k, v in parts.items()} }")
    return dict(rows=rows, host_us=host_us, masks=masks, edges=edges, ln_edges=ln_edges,
                tp_rows=tp_rows, option_rows=option_rows, packed_rows=packed_rows,
                moe=moe_rows, part_seconds=parts)


# ------------------------------------------------------------ slice phase

def _synthetic_item(rng, vocab, i, n_boxes=36):
    cjk = vocab[200:]
    title = "".join(cjk[j] for j in rng.integers(0, len(cjk), 48))
    pv = "".join("".join(cjk[j] for j in rng.integers(0, len(cjk), 3)) + ":"
                 + "".join(cjk[j] for j in rng.integers(0, len(cjk), 4)) + ";"
                 for _ in range(30))
    h, w = 480, 640
    x0 = rng.uniform(0, w / 2, n_boxes)
    y0 = rng.uniform(0, h / 2, n_boxes)
    boxes = np.stack([x0, y0, x0 + rng.uniform(8, w / 2, n_boxes),
                      y0 + rng.uniform(8, h / 2, n_boxes)], 1).astype(np.float32)
    cls = rng.random((n_boxes, 1601), dtype=np.float32)
    return dict(item_id=f"item{i}", title=title, pv=pv, category="c",
                image_h=h, image_w=w, num_boxes=n_boxes, boxes=boxes,
                features=rng.random((n_boxes, 2048), dtype=np.float32),
                cls_prob=cls / cls.sum(1, keepdims=True))


def write_pair_records(path, n=N_PAIRS):
    """Phase 4's pairs, the first `n` of them."""
    from k3m_tpu_torch.data.records import write_records
    from k3m_tpu_torch.tokenization import build_synthetic_vocab
    rng = np.random.default_rng(SEED)
    vocab = build_synthetic_vocab()
    pairs = (dict(label=float(i % 2), item1=_synthetic_item(rng, vocab, 2 * i),
                  item2=_synthetic_item(rng, vocab, 2 * i + 1))
             for i in range(n))
    return write_records(str(path), pairs)


def layer_counts(cfg):
    """(LN-layer applications, attention calls, connection layers) of one
    trunk forward of one process (no shared_prefix, image and co-attention
    on). Every text layer runs 4 times (t and pv in passes t<->v, pv<->v,
    and both streams of t<->pv), every image layer twice; 2 LNs per
    application, 1 attention call per stream. Under packed_passes (without
    in_batch_pairs or fast_mode) each text layer runs once over the 4
    streams' packed rows (4 attention calls) and each image layer once at
    2B rows (1 call; a training forward with dropout under data parallelism
    makes one per copy of the batch, dist.stacked, which no phase runs)."""
    packed = cfg.packed_passes and not (cfg.in_batch_pairs or cfg.fast_mode)
    lt, lv = cfg.num_hidden_layers, cfg.v_num_hidden_layers
    if packed:
        return lt + lv, 4 * lt + lv, 3 * cfg.num_coattention_layers
    return 4 * lt + 2 * lv, 4 * lt + 2 * lv, 3 * cfg.num_coattention_layers


def expected_launches(cfg, n_item_forwards):
    """Kernel launches of one item forward of K3MForItemAlignment, times the
    number of item forwards: 3 embedding LNs, 2 LNs per layer application
    and 1 attention per stream (layer_counts), 4 LNs + 1 bi-attention per
    connection layer (3 stacks)."""
    layers, attn, conn = layer_counts(cfg)
    return dict(fused_layernorm=n_item_forwards * (3 + 2 * layers + 4 * conn),
                fused_attention=n_item_forwards * attn,
                fused_biattention=n_item_forwards * conn)


def vector_ln_only(what, card):
    """Every LN forward of `what` took the vector instance: the per-element
    instance's counter (reset with the others) reads 0."""
    from k3m_tpu_torch.kernels import fused_layernorm
    n = fused_layernorm.per_element_launches
    log(f"{what}: LN forward per-element launches {n} (of {fused_layernorm.launches}) | {card}")
    if n:
        raise AssertionError(f"{what}: {n} LN forward launches took the per-element instance")
    return n


def phase_slice(card, profile=False):
    from k3m_tpu_torch import finetune, kernels
    from k3m_tpu_torch.config import K3MConfig

    data_dir, out_dir = WORK / "data", WORK / "out"
    t0 = time.perf_counter()
    n = write_pair_records(data_dir / "test_item_alignment.k3mr")
    log(f"slice: wrote {n} pair records in {time.perf_counter() - t0:.1f} s")
    argv = ["--data_dir", str(data_dir), "--output_dir", str(out_dir),
            "--file_test", "test_item_alignment.k3mr", "--use_image",
            "--with_coattention", "--do_pred", "--bf16",
            "--eval_batch_size", str(BATCH), "--seed", str(SEED),
            "--config_file", "bert_base_6layer_6conect.json", "--log_steps", "1"]
    for k, v in SHAPES.items():
        argv += [f"--{k}", str(v)]

    kernels.reset_launch_counts()
    stats = finetune.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    cfg = K3MConfig.from_json_file(
        str(ROOT / "k3m_tpu_torch" / "configs" / "bert_base_6layer_6conect.json"))
    batches = math.ceil(N_PAIRS / BATCH)
    expected = expected_launches(cfg, 2 * batches)
    log(f"slice: launches {counts} expected {expected}")
    for name, want in expected.items():
        if counts[name] != want or counts[name] == 0:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")
    per_element = vector_ln_only("slice", card)

    lines = Path(stats["output"]).read_text().splitlines()
    if len(lines) != N_PAIRS:
        raise AssertionError(f"{len(lines)} jsonl lines, expected {N_PAIRS}")
    for line in lines:
        rec = json.loads(line)
        for key in ("src_item_emb", "tgt_item_emb"):
            if not math.isfinite(float(rec[key])):
                raise AssertionError(f"non-finite {key}: {rec}")
    timed = stats["batch_seconds"][1:]           # batch 0 is the warm-up
    timed_pairs = sum(stats["batch_pairs"][1:])
    pairs_per_s = timed_pairs / sum(timed)
    log(f"slice: {len(lines)} finite jsonl lines; predict {pairs_per_s:.2f} pairs/s "
        f"over {len(timed)} timed batches of {BATCH} (bf16, loader included) | {card}")
    loader_s = loader_rate(cfg, data_dir / "test_item_alignment.k3mr", card)
    device = device_forward_rate(cfg, data_dir / "test_item_alignment.k3mr", card,
                                 profile)
    return dict(launches=counts, expected=expected, pairs_per_s=pairs_per_s,
                batch_seconds=stats["batch_seconds"], loader_s_per_batch=loader_s,
                ln_per_element_launches=per_element, **device)


def _shapes():
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    return ShapeSpec(max_seq_len=SHAPES["max_seq_length"],
                     max_seq_len_pv=SHAPES["max_seq_length_pv"],
                     max_num_pv=SHAPES["max_num_pv"],
                     max_region_len=SHAPES["max_region_length"])


def _loader(path, cfg, batch_size, native=True, shuffle=False, drop_last=False, **shard):
    """The pair loader (native producer unless `native` is False), as
    finetune's eval loader (or, shuffled and dropping the remainder, its
    train loader) makes it; `shard`: num_shards and shard_index."""
    from k3m_tpu_torch.data.pipeline import AlignmentLoader
    from k3m_tpu_torch.tokenization import get_tokenizer
    return AlignmentLoader(str(path), get_tokenizer(None, cfg.vocab_size), _shapes(),
                           batch_size=batch_size, shuffle=shuffle, seed=SEED,
                           drop_last=drop_last, native_preprocess=native, **shard)


def _load_batch(path, cfg, batch_size):
    return next(iter(_loader(path, cfg, batch_size)))


def loader_rate(cfg, path, card, batch=BATCH, what="slice"):
    """Seconds per batch of the pair loader alone (read, tokenize,
    preprocess, collate on its producer thread), over the whole file."""
    loader = _loader(path, cfg, batch)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    s_per_batch = (time.perf_counter() - t0) / n
    log(f"{what}: loader alone ({loader.producer} producer) {s_per_batch:.4f} s per batch "
        f"of {batch} pairs over {n} batches (host) | {card}")
    return s_per_batch


def _model(cfg, device):
    from k3m_tpu_torch.model.alignment import build_model
    return build_model(cfg, seed=SEED, device=device)


def _kernel_class(name):
    for key, cls in (("biattn_fwd", "fused_biattention"),
                     ("attn_fwd", "fused_attention"),
                     ("attn_bwd", "attention_bwd"),
                     ("ln_fwd", "fused_layernorm"),
                     ("ln_bwd", "layernorm_bwd")):
        if key in name:
            return cls
    low = name.lower()
    if any(k in low for k in ("fprop", "convolve", "cudnn", "winograd", "fft")):
        return "conv"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_device(fn, card, what, n=2):
    """Device time by kernel class over `n` calls of `fn` (torch.profiler),
    and the device's idle share of the wall time of those calls. The times
    are read from the exported trace, one event per kernel, copy or memset
    (the profiler's key_averages() left out about half of a train step's
    kernels); the kernels it holds are counted against the launch calls the
    host made, and where kernels are missing, busy and idle share are marked
    as undercounted where over 1% are missing."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    WORK.mkdir(parents=True, exist_ok=True)
    trace = WORK / "profile_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    by_class, launches, others, ours = {}, {}, {}, {}
    host_launches = sum(1 for e in events
                        if e.get("ph") == "X" and e.get("name") in LAUNCH_CALLS) // n
    seen = 0       # kernels in the trace (copies and memsets aside)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        name = e.get("name", "")
        cls = _kernel_class(name) if e["cat"] == "kernel" else "other"
        seen += e["cat"] == "kernel"
        ms = e.get("dur", 0.0) / 1e3 / n
        by_class[cls] = by_class.get(cls, 0.0) + ms
        launches[cls] = launches.get(cls, 0) + 1
        if cls == "other":
            ms0, c0 = others.get(name[:80], (0.0, 0))
            others[name[:80]] = (ms0 + ms, c0 + 1)
        elif cls != "matmul":      # the port's kernels, each by its own name
            m = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
            short = m.group(1) if m else name[:80]
            ours[short] = ours.get(short, 0.0) + ms
    seen //= n
    launches = {k: c // n for k, c in launches.items()}
    others = sorted(((ms, c // n, k) for k, (ms, c) in others.items()), reverse=True)
    busy = sum(by_class.values())
    idle = 1.0 - busy * n / wall_ms if wall_ms > 0 else None
    complete = seen >= 0.99 * host_launches
    log(f"profile: per {what}, device ms by kernel class "
        f"{ {k: round(v, 3) for k, v in sorted(by_class.items())} } launches "
        f"{launches}; busy {busy:.2f} ms, wall {wall_ms / n:.2f} ms under the "
        f"profiler, idle share {idle}; the trace holds {seen} kernels for "
        f"{host_launches} kernel launch calls"
        f"{'' if complete else ' (over 1% lost: busy undercounted, idle overcounted)'} | {card}")
    log(f"profile: the port's kernels by name, device ms "
        f"{ {k: round(v, 3) for k, v in sorted(ours.items())} }")
    for ms, count, name in others[:8]:
        log(f"profile: other {ms:.3f} ms in {count} launches of {name}")
    if busy == 0:
        raise AssertionError("the profiler saw no device time")
    return dict(device_ms_by_class=by_class, launches_by_class=launches,
                busy_ms=busy, wall_ms_profiled=wall_ms / n, idle_share=idle,
                host_launch_calls=host_launches, complete=complete, kernels_by_name=ours,
                top_other=others[:20])


def log_busy_share(what, busy_ms, step_ms, card):
    """The card's busy time of one profiled step beside the unprofiled
    steps' mean host time: how much of a step is the card's work and how
    much the host's (launches, loader, Python)."""
    mean = sum(step_ms) / len(step_ms)
    log(f"{what}: device busy {busy_ms:.2f} ms of one profiled step, mean step "
        f"{mean:.2f} ms unprofiled: busy share {busy_ms / mean:.3f}, idle share "
        f"estimate {1 - busy_ms / mean:.3f} | {card}")


def device_forward_rate(cfg, path, card, profile=False):
    """Model forward alone, batch resident on the card, bf16."""
    from k3m_tpu_torch.train.alignment_loop import batch_to_device, forward
    cfg = cfg.replace(use_image=True, with_coattention=True, loss_type="ce",
                      dtype="bfloat16")
    model = _model(cfg, "cuda")
    batch = batch_to_device(_load_batch(path, cfg, BATCH), torch.device("cuda"))
    ms = cuda_ms(lambda: forward(model, batch), iters=5, warmup=2)
    rate = BATCH / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"slice: device forward {ms:.2f} ms per batch of {BATCH} pairs = "
        f"{rate:.2f} pairs/s (bf16, batch on the card); peak memory "
        f"{peak:.2f} GiB | {card}")
    res = dict(forward_ms=ms, forward_pairs_per_s=rate, peak_gib=peak)
    if profile:
        res["profile"] = profile_device(lambda: forward(model, batch), card,
                                        f"bf16 forward of {BATCH} pairs")
    del model
    torch.cuda.empty_cache()
    return res


def phase_crosscheck(card):
    """fp32, card vs CPU. Fusion strategy 0 (mean) here: strategy 1's
    argmax over near-equal sigmoid scores turns 1e-6 differences into
    discrete selection flips (seen: c_final 1.06e-3 off on one item), which
    would test the argmax, not the kernels."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.train.alignment_loop import batch_to_device, forward
    cfg = K3MConfig.from_json_file(
        str(ROOT / "k3m_tpu_torch" / "configs" / "bert_base_6layer_6conect.json")
    ).replace(use_image=True, with_coattention=True, loss_type="ce",
              if_pre_sampling=0)
    batch = _load_batch(WORK / "data" / "test_item_alignment.k3mr", cfg, 2)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = _model(cfg, dev)
        b = batch_to_device(batch, torch.device(dev))
        with torch.inference_mode():
            e1, e2, probs, loss = forward(model, b)
            c1 = model.item_embedding(b["item1"])[1]
            c2 = model.item_embedding(b["item2"])[1]
        outs[dev] = [t.float().cpu() for t in (e1, e2, probs, c1, c2)]
        del model
    # 1e-4 of the output scale: fp32 on both sides, but ~200 layer
    # applications of differently ordered sums at full width
    worst = 0.0
    for name, a, b in zip(("emb1", "emb2", "probs", "c_final1", "c_final2"),
                          outs["cpu"], outs["cuda"]):
        err = max_err(a, b)
        tol = 1e-4 * max(1.0, float(a.abs().max()))
        worst = max(worst, err / tol)
        log(f"crosscheck {name}: max_abs_err card vs cpu {err:.3e} (tol {tol:.1e})")
        if not (torch.isfinite(b).all() and err <= tol):
            raise AssertionError(f"crosscheck {name} failed: {err} > {tol}")
    log(f"crosscheck: fp32 2-pair batch agrees card vs CPU | {card}")
    return worst


# ------------------------------------------------------------ train phase

ROBERTA = ROOT / "k3m_tpu_torch" / "configs" / "k3m_roberta_base.json"


def write_pretrain_records(path, n, seed=SEED + 1):
    from k3m_tpu_torch.data.records import write_records
    from k3m_tpu_torch.tokenization import build_synthetic_vocab
    rng = np.random.default_rng(seed)
    vocab = build_synthetic_vocab()
    return write_records(str(path), (_synthetic_item(rng, vocab, i) for i in range(n)))


def _pretrain_argv(data_dir, out_dir, *extra, epochs=1):
    """`k3m_tpu_torch.pretrain`: bf16, image on, batch 96, the full shapes,
    random weights from SEED; full width unless `data_dir` holds a config
    at DEPTH_CUT (write_cut_config)."""
    argv = ["--data_dir", str(data_dir), "--output_dir", str(out_dir),
            "--file_name", "{}_feat.k3mr", "--bf16", "--use_image",
            "--train_batch_size", str(TRAIN_BATCH), "--num_train_epochs", str(epochs),
            "--seed", str(SEED), "--log_steps", "1", *extra]
    for k, v in SHAPES.items():
        argv += [f"--{k}", str(v)]
    return argv


def expected_train_launches(cfg, steps, head_lns=3, embedding_lns=3):
    """Kernel launches of `steps` trunk forwards and backwards (image and
    co-attention on), K3MForPretraining's by default: the forward as one
    item forward of the serving path (its `embedding_lns` LNs of the
    embeddings; 0 for the encoder alone) plus the heads' `head_lns` LNs
    (the MLM transform for title and pv, the RoI transform); every LN and
    attention has its backward, and each bi-attention two (one per
    direction); layer_counts gives the layers and calls."""
    layers, attn, conn = layer_counts(cfg)
    ln = embedding_lns + 2 * layers + 4 * conn + head_lns
    return dict(fused_layernorm=steps * ln, layernorm_bwd=steps * ln,
                fused_attention=steps * attn,
                attention_bwd=steps * (attn + 2 * conn),
                fused_biattention=steps * conn)


def _pretrain_loader(path, cfg, batch_size, native=True, shuffle=False):
    """The pretraining loader (native producer unless `native` is False);
    shuffled, it is the one the pretraining CLI makes."""
    from k3m_tpu_torch.data.pipeline import PretrainLoader
    from k3m_tpu_torch.tokenization import get_tokenizer
    return PretrainLoader(str(path), get_tokenizer(None, cfg.vocab_size), _shapes(),
                          batch_size=batch_size, shuffle=shuffle, seed=SEED,
                          native_preprocess=native)


def _require_native(run, what):
    """The CLI run `run` trained on the native producer."""
    if run["producer"] != "native":
        raise AssertionError(f"{what}: the train loader ran the {run['producer']} producer")


def producer_comparison(trainer, loader, what, native_rate, unit, card):
    """One more epoch of `trainer` on the Python producer's batches (the
    same loader otherwise), no checkpoint: its rate over the steps after
    the first beside the native producer's rate of the CLI run."""
    if loader.producer != "python":
        raise AssertionError(f"{what}: the comparison loader is not the Python producer")
    (hist,) = trainer.fit(loader, num_epochs=1, log_steps=0)
    n = hist.get("step_samples", hist.get("step_pairs"))
    rate = sum(n[1:]) / sum(hist["step_seconds"][1:])
    log(f"{what}: native producer {native_rate:.2f} {unit}/s, Python producer {rate:.2f} "
        f"{unit}/s (one more epoch of the same trainer, steps 2-{len(n)} each, same run; "
        f"no gain is claimed across runs) | {card}")
    return rate


def checkpoint_sizes(path):
    """GiB of an epoch checkpoint's state.pt and pytorch_model.bin."""
    return tuple(Path(path, name).stat().st_size / 2 ** 30
                 for name in ("state.pt", "pytorch_model.bin"))


def phase_train(card):
    from k3m_tpu_torch import kernels, pretrain
    from k3m_tpu_torch.config import K3MConfig

    data_dir, out_dir = WORK / "pretrain_data", WORK / "pretrain_out"
    t0 = time.perf_counter()
    n = write_pretrain_records(data_dir / "train_feat.k3mr", TRAIN_STEPS * TRAIN_BATCH)
    log(f"train: wrote {n} pretraining records in {time.perf_counter() - t0:.1f} s")
    cfg = K3MConfig.from_json_file(str(ROBERTA))
    argv = _pretrain_argv(data_dir, out_dir)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = pretrain.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    _require_native(run, "train")
    (hist,) = run["history"]
    steps = len(hist["step_seconds"])
    expected = expected_train_launches(cfg, steps)
    log(f"train: launches {counts} expected {expected}")
    if steps != TRAIN_STEPS:
        raise AssertionError(f"{steps} train steps, expected {TRAIN_STEPS}")
    for name, want in expected.items():
        if counts[name] != want or counts[name] == 0:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")
    per_element = vector_ln_only("train", card)
    for i, losses in enumerate(hist["step_losses"]):
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train step {i}: non-finite losses {losses}")
    timed = hist["step_seconds"][1:]
    samples_per_s = sum(hist["step_samples"][1:]) / sum(timed)
    step_ms = [1e3 * t for t in timed]
    log(f"train: {steps} steps of {TRAIN_BATCH}, losses finite (first "
        f"{hist['step_losses'][0]['loss']:.4f}, last {hist['step_losses'][-1]['loss']:.4f}); "
        f"{samples_per_s:.2f} samples/s over steps 2-{steps}, step ms mean "
        f"{sum(step_ms) / len(step_ms):.2f} min {min(step_ms):.2f} max {max(step_ms):.2f} "
        f"(first {1e3 * hist['step_seconds'][0]:.2f}); peak memory {peak:.2f} GiB "
        f"(bf16, k3m_roberta_base, loader included) | {card}")
    ckpt_gib, model_gib = checkpoint_sizes(hist["checkpoint_path"])
    log(f"train: epoch checkpoint {ckpt_gib:.2f} GiB (state.pt: model, AdamW and step) and "
        f"{model_gib:.2f} GiB (pytorch_model.bin: the model) written in "
        f"{hist['checkpoint_seconds']:.2f} s (outside step ms) | {card}")
    # phase 12 starts a finetune run from the model file; the full state goes
    Path(hist["checkpoint_path"], "state.pt").unlink()
    res = dict(launches=counts, expected=expected, samples_per_s=samples_per_s,
               ln_per_element_launches=per_element,
               step_ms=step_ms, first_step_ms=1e3 * hist["step_seconds"][0],
               peak_gib=peak, checkpoint_s=hist["checkpoint_seconds"],
               checkpoint_gib=ckpt_gib, model_file_gib=model_gib,
               step_losses=hist["step_losses"])
    trainer = run["trainer"]
    batch = trainer.stage(next(iter(_pretrain_loader(
        data_dir / "train_feat.k3mr", cfg, TRAIN_BATCH))))
    res["profile"] = profile_device(lambda: trainer.train_step(batch), card,
                                    f"bf16 train step of {TRAIN_BATCH}", n=1)
    log_busy_share("train", res["profile"]["busy_ms"], step_ms, card)
    res["python_producer_samples_per_s"] = producer_comparison(
        trainer, _pretrain_loader(data_dir / "train_feat.k3mr", cfg, TRAIN_BATCH,
                                  native=False, shuffle=True),
        "train", samples_per_s, "samples", card)
    del run, trainer, batch
    torch.cuda.empty_cache()
    return res


def phase_train_crosscheck(card, flags=None, what="train crosscheck"):
    """One fp32 train step (losses and backward) at batch 2 on the card
    (kernels) and on the CPU (plain versions), same seeded weights, dropout
    off, injected LPM negatives and Gumbel noise; `flags`: config options
    set on both (phase 25). The noise puts its
    one-hot pick 4 above the other options, so 1e-6 differences cannot flip
    a hard selection (that would test the argmax, not the kernels).
    Tolerances: losses 1e-4 of their scale; each gradient tensor 1e-3 of
    its largest magnitude plus 1e-7 (fp32 on both sides, but a full-width
    backward through ~300 layer applications, sums in another order, and
    gradients that are zero in exact arithmetic)."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    cfg = K3MConfig.from_json_file(str(ROBERTA)).replace(use_image=True, objective=2,
                                                         **(flags or {}))
    batch = next(iter(_pretrain_loader(WORK / "pretrain_data" / "train_feat.k3mr", cfg, 2)))
    rng = np.random.default_rng(SEED)
    B, P = 2, SHAPES["max_num_pv"]
    lens = dict(v=SHAPES["max_region_length"] + 1, t=SHAPES["max_seq_length"],
                pv=SHAPES["max_seq_length_pv"])
    sizes = dict(v=cfg.bi_hidden_size, t=cfg.hidden_size, pv=cfg.hidden_size)
    batch["neg_entity_idx"] = rng.integers(0, B, (B, P, 2))
    batch["neg_value_idx"] = rng.integers(0, P, (B, P, 2))
    batch["gumbel_noise"] = {
        m: (4.0 * np.eye(3)[rng.integers(0, 3, (B, lens[m], sizes[m]))].transpose(0, 1, 3, 2)
            + 0.1 * rng.standard_normal((B, lens[m], 3, sizes[m]))).astype(np.float32)
        for m in lens}
    results = {}
    for dev in ("cpu", "cuda"):
        trainer = PretrainTrainer(cfg, device=dev, seed=SEED, objective=2)
        loss, metrics = trainer.losses(trainer.stage(batch), deterministic=True)
        loss.backward()
        results[dev] = ({k: float(v) for k, v in metrics.items()},
                        {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()
                         if p.grad is not None})
        del trainer, loss
        torch.cuda.empty_cache()
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results["cuda"]
    for k in ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv", "loss_struc"):
        err, tol = abs(l_gpu[k] - l_cpu[k]), 1e-4 * max(1.0, abs(l_cpu[k]))
        log(f"{what} {k}: card {l_gpu[k]:.6f} cpu {l_cpu[k]:.6f} (tol {tol:.1e})")
        if not (math.isfinite(l_gpu[k]) and err <= tol):
            raise AssertionError(f"{what} {k}: {err} > {tol}")
    if set(g_cpu) != set(g_gpu) or not g_cpu:
        raise AssertionError(f"{what}: the two devices gave different gradients")
    worst, worst_name = 0.0, None
    for name, a in g_cpu.items():
        tol = 1e-3 * float(a.abs().max()) + 1e-7
        ratio = max_err(g_gpu[name], a) / tol
        if ratio > worst:
            worst, worst_name = ratio, name
        if not (torch.isfinite(g_gpu[name]).all() and ratio <= 1.0):
            raise AssertionError(f"{what} gradient {name}: "
                                 f"{max_err(g_gpu[name], a)} > {tol}")
    log(f"{what}: {len(g_cpu)} gradient tensors agree card vs CPU; worst "
        f"error/tolerance {worst:.3e} ({worst_name}) | {card}")
    return dict(losses_cpu=l_cpu, losses_card=l_gpu, worst_grad_ratio=worst,
                worst_grad=worst_name, n_grads=len(g_cpu))


# --------------------------------------------------------- finetune phase

BERT = ROOT / "k3m_tpu_torch" / "configs" / "bert_base_6layer_6conect.json"


def write_finetune_records(data_dir, n_train=FT_STEPS * FT_BATCH, n_valid=FT_VALID):
    """`n_train` training pairs (FT_STEPS batches of FT_BATCH) and `n_valid`
    validation pairs at the full shapes."""
    from k3m_tpu_torch.data.records import write_records
    from k3m_tpu_torch.tokenization import build_synthetic_vocab
    rng = np.random.default_rng(SEED + 2)
    vocab = build_synthetic_vocab()

    def pairs(first, n):
        return (dict(label=float(i % 2), item1=_synthetic_item(rng, vocab, 2 * i),
                     item2=_synthetic_item(rng, vocab, 2 * i + 1))
                for i in range(first, first + n))
    n_train = write_records(str(data_dir / "train_item_alignment.k3mr"),
                            pairs(0, n_train))
    n_valid = write_records(str(data_dir / "valid_item_alignment.k3mr"),
                            pairs(n_train, n_valid))
    return n_train, n_valid


def expected_finetune_launches(cfg, steps, eval_batches):
    """Kernel launches of `steps` finetune train steps (two item trunks a
    step, forward and backward, no pretraining heads) and the sweep's
    forwards over `eval_batches` validation batches (two items each)."""
    train = expected_train_launches(cfg, 2 * steps, head_lns=0)
    sweep = expected_launches(cfg, 2 * eval_batches)
    return {k: v + sweep.get(k, 0) for k, v in train.items()}


def check_staged_prefetch(trainer, path, cfg, card):
    """Batches staged by staged_prefetch (producer thread, side stream,
    event, record_stream) equal, bit for bit and in order, those staged
    on the calling thread."""
    staged = list(trainer.prefetch(_loader(path, cfg, FT_BATCH)))
    direct = [trainer.stage(b) for b in _loader(path, cfg, FT_BATCH)]
    torch.cuda.synchronize()
    if len(staged) != len(direct) or not staged:
        raise AssertionError(f"staged_prefetch gave {len(staged)} batches, expected "
                             f"{len(direct)}")
    n = 0
    for i, (a, b) in enumerate(zip(staged, direct)):
        pairs = [("label", a["label"], b["label"])] + [
            (f"{side}/{k}", a[side][k], b[side][k]) for side in ("item1", "item2")
            for k in b[side]]
        for name, x, y in pairs:
            if not (x.is_cuda and x.dtype == y.dtype and torch.equal(x, y)):
                raise AssertionError(f"staged_prefetch batch {i} {name} differs")
            n += 1
    log(f"finetune: staged_prefetch gave {len(staged)} batches, {n} tensors on the card "
        f"bit for bit those staged directly, in order | {card}")
    return dict(batches=len(staged), tensors=n)


def phase_finetune(card):
    """`k3m_tpu_torch.finetune --do_train --do_eval` with the flags of
    run_finetune_item_alignment.sh at full width, one epoch of FT_STEPS
    steps, random weights from a seed."""
    from k3m_tpu_torch import finetune, kernels
    from k3m_tpu_torch.config import K3MConfig

    data_dir, out_dir = WORK / "finetune_data", WORK / "finetune_out"
    data_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    n_train, n_valid = write_finetune_records(data_dir)
    log(f"finetune: wrote {n_train} train and {n_valid} validation pair records in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = K3MConfig.from_json_file(str(BERT))
    argv = ["--data_dir", str(data_dir), "--output_dir", str(out_dir),
            "--config_file", "bert_base_6layer_6conect.json", "--use_image",
            "--with_coattention", "--do_train", "--do_eval", "--bf16", "--loss_type", "inner",
            "--if_pre_sampling", "1", "--train_batch_size", str(FT_BATCH),
            "--eval_batch_size", str(FT_BATCH), "--learning_rate", "5e-5",
            "--warmup_proportion", "0.3", "--num_train_epochs", "1", "--seed", str(SEED),
            "--log_steps", "1"]
    for k, v in SHAPES.items():
        argv += [f"--{k}", str(v)]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = finetune.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    _require_native(run, "finetune")
    (hist,) = run["history"]
    steps = len(hist["step_seconds"])
    expected = expected_finetune_launches(cfg, steps, math.ceil(FT_VALID / FT_BATCH))
    log(f"finetune: launches {counts} expected {expected} ({steps} train steps and the "
        f"sweep's forwards)")
    if steps != FT_STEPS:
        raise AssertionError(f"{steps} finetune steps, expected {FT_STEPS}")
    for name, want in expected.items():
        if counts[name] != want or counts[name] == 0:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")
    per_element = vector_ln_only("finetune", card)
    losses = hist["step_losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"finetune: non-finite step losses {losses}")
    sweep = hist["sweep"]
    if sorted(sweep) != [round(0.1 * i, 1) for i in range(1, 10)] or not all(
            0.0 <= m[k] <= 1.0 for m in sweep.values() for k in ("precision", "recall", "f1")):
        raise AssertionError(f"finetune: the threshold sweep is malformed: {sweep}")
    ckpt = Path(hist["checkpoint_path"]) / "state.pt"
    latest = json.loads((out_dir / "latest.json").read_text())
    if not ckpt.exists() or latest["epoch"] != 0:
        raise AssertionError(f"finetune: no epoch checkpoint ({ckpt}, {latest})")
    ckpt_gib, model_gib = checkpoint_sizes(hist["checkpoint_path"])
    shutil.rmtree(out_dir)
    timed = hist["step_seconds"][1:]
    pairs_per_s = sum(hist["step_pairs"][1:]) / sum(timed)
    step_ms = [1e3 * t for t in timed]
    log(f"finetune: {steps} steps of {FT_BATCH} pairs, losses finite (first {losses[0]:.4f}, "
        f"last {losses[-1]:.4f}); {pairs_per_s:.2f} pairs/s over steps 2-{steps}, step ms "
        f"mean {sum(step_ms) / len(step_ms):.2f} min {min(step_ms):.2f} max {max(step_ms):.2f} "
        f"(first {1e3 * hist['step_seconds'][0]:.2f}); peak memory {peak:.2f} GiB (bf16, "
        f"bert_base_6layer_6conect, loss inner, loader and sweep included) | {card}")
    log(f"finetune: sweep at 0.5 {sweep[0.5]}; epoch checkpoint {ckpt_gib:.2f} + "
        f"{model_gib:.2f} GiB (state.pt, pytorch_model.bin) written in "
        f"{hist['checkpoint_seconds']:.2f} s (outside step ms) | {card}")
    trainer = run["trainer"]
    prefetch = check_staged_prefetch(trainer, data_dir / "valid_item_alignment.k3mr", cfg,
                                      card)
    res = dict(launches=counts, expected=expected, pairs_per_s=pairs_per_s, step_ms=step_ms,
               ln_per_element_launches=per_element,
               first_step_ms=1e3 * hist["step_seconds"][0], peak_gib=peak,
               checkpoint_s=hist["checkpoint_seconds"], checkpoint_gib=ckpt_gib,
               model_file_gib=model_gib, step_losses=losses, sweep=sweep, prefetch=prefetch)
    batch = trainer.stage(_load_batch(data_dir / "train_item_alignment.k3mr", cfg,
                                      FT_BATCH))
    res["profile"] = profile_device(lambda: trainer.train_step(batch), card,
                                    f"bf16 finetune train step of {FT_BATCH} pairs", n=1)
    log_busy_share("finetune", res["profile"]["busy_ms"], step_ms, card)
    res["python_producer_pairs_per_s"] = producer_comparison(
        trainer, _loader(data_dir / "train_item_alignment.k3mr", cfg, FT_BATCH, native=False,
                         shuffle=True, drop_last=True),
        "finetune", pairs_per_s, "pairs", card)
    del run, trainer, batch
    torch.cuda.empty_cache()
    return res


# the structure scores' softmax-shift bias: its gradient is zero in exact
# arithmetic, so its own scale is rounding noise
ZERO_GRAD_BIAS = "struc_w2.bias"


def phase_finetune_crosscheck(card):
    """One fp32 finetune train step at batch 2 for loss_type inner and ce,
    dropout 0 and fusion strategy 2 (no draws), on the card (kernels) and
    on the CPU (plain versions), same seeded weights: the loss within 1e-4
    of its scale, each gradient tensor within 1e-3 of its largest magnitude
    plus 1e-7, as phase 7 holds them; but struc_w2.bias, whose gradient is
    zero in exact arithmetic, is held to struc_w2.weight's gradient scale
    (held to its own scale, its rounding noise came to 0.95 of the limit
    under the inner loss on an H100; the attention keys' biases, also zero
    in exact arithmetic, pass at their own scale as in phase 7)."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.alignment import build_model
    from k3m_tpu_torch.model.random import StepRandom
    from k3m_tpu_torch.train.alignment_loop import batch_to_device
    base = K3MConfig.from_json_file(str(BERT)).replace(
        use_image=True, with_coattention=True, if_pre_sampling=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, v_hidden_dropout_prob=0.0,
        v_attention_probs_dropout_prob=0.0)
    batch = _load_batch(WORK / "finetune_data" / "train_item_alignment.k3mr", base, 2)
    out = {}
    for loss_type in ("inner", "ce"):
        cfg = base.replace(loss_type=loss_type)
        results = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, seed=SEED, device=dev, train=True)
            b = batch_to_device(batch, torch.device(dev))
            loss = model(b["label"], b["item1"], b["item2"], deterministic=False,
                         rng=StepRandom(SEED, 0, dev))[3]
            loss.backward()
            results[dev] = (loss.item(), {n: p.grad.float().cpu()
                                          for n, p in model.named_parameters()
                                          if p.grad is not None})
            del model, loss
            torch.cuda.empty_cache()
        (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results["cuda"]
        err, tol = abs(l_gpu - l_cpu), 1e-4 * max(1.0, abs(l_cpu))
        log(f"finetune crosscheck {loss_type}: loss card {l_gpu:.6f} cpu {l_cpu:.6f} "
            f"(tol {tol:.1e})")
        if not (math.isfinite(l_gpu) and err <= tol):
            raise AssertionError(f"finetune crosscheck {loss_type} loss: {err} > {tol}")
        if set(g_cpu) != set(g_gpu) or not g_cpu:
            raise AssertionError(f"finetune crosscheck {loss_type}: the two devices gave "
                                 "different gradients")
        worst, worst_name = 0.0, None
        for name, a in g_cpu.items():
            scale = g_cpu["struc_w2.weight"] if name == ZERO_GRAD_BIAS else a
            tol = 1e-3 * float(scale.abs().max()) + 1e-7
            ratio = max_err(g_gpu[name], a) / tol
            if ratio > worst:
                worst, worst_name = ratio, name
            if not (torch.isfinite(g_gpu[name]).all() and ratio <= 1.0):
                raise AssertionError(f"finetune crosscheck {loss_type} gradient {name}: "
                                     f"{max_err(g_gpu[name], a)} > {tol}")
        bias = g_cpu[ZERO_GRAD_BIAS]
        own = max_err(g_gpu[ZERO_GRAD_BIAS], bias) / (1e-3 * float(bias.abs().max()) + 1e-7)
        log(f"finetune crosscheck {loss_type}: {len(g_cpu)} gradient tensors agree card vs "
            f"CPU; worst error/tolerance {worst:.3e} ({worst_name}); {ZERO_GRAD_BIAS} at "
            f"its own scale would read {own:.3e} (not held) | {card}")
        out[loss_type] = dict(loss_cpu=l_cpu, loss_card=l_gpu, worst_grad_ratio=worst,
                              worst_grad=worst_name, n_grads=len(g_cpu),
                              zero_grad_bias_own_scale_ratio=own)
    return out


# ------------------------------------------------- native producer phase

def phase_native_build(card):
    """Build the native library (g++) and the unicode tables it reads;
    runs beside the CUDA build."""
    from k3m_tpu_torch import runtime
    from k3m_tpu_torch.runtime.unicode_tables import get_tables
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    path = runtime.build()
    runtime.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    get_tables()
    tables_s = time.perf_counter() - t0
    log(f"native: {path} built in {build_s:.2f} s by {gxx}; unicode tables in "
        f"{tables_s:.2f} s (host) | {card}")
    return dict(path=str(path), build_s=build_s, tables_s=tables_s, gxx=gxx)


def _same_batch(a, b, where):
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{where}: keys {sorted(a)} != {sorted(b)}")
        for k in a:
            _same_batch(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        if a != b:
            raise AssertionError(f"{where} differs")
    elif not (a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()):
        raise AssertionError(f"{where} differs ({a.dtype}{a.shape} vs {b.dtype}{b.shape})")


def phase_native(card):
    """Both full-width loaders run the native producer; its batches equal the
    Python producer's byte for byte over the whole file; seconds per batch
    of each producer alone (read, tokenize, mask, collate on the loader's
    thread)."""
    from k3m_tpu_torch.config import K3MConfig
    cases = (("pretraining", TRAIN_BATCH, lambda native: _pretrain_loader(
                 WORK / "pretrain_data" / "train_feat.k3mr", K3MConfig.from_json_file(
                     str(ROBERTA)), TRAIN_BATCH, native=native, shuffle=True)),
             ("pairs", FT_BATCH, lambda native: _loader(
                 WORK / "finetune_data" / "train_item_alignment.k3mr",
                 K3MConfig.from_json_file(str(BERT)), FT_BATCH, native=native, shuffle=True,
                 drop_last=True)))
    out = {}
    for what, batch, make in cases:
        seconds, batches = {}, {}
        for native in (True, False):
            loader = make(native)
            want = "native" if native else "python"
            if loader.producer != want:
                raise AssertionError(f"native: the {what} loader runs the {loader.producer} "
                                     f"producer, not the {want} one: {loader.native_error}")
            t0 = time.perf_counter()
            batches[want] = list(loader)
            seconds[want] = (time.perf_counter() - t0) / len(batches[want])
        if len(batches["native"]) != len(batches["python"]) or not batches["native"]:
            raise AssertionError(f"native: {what}: {len(batches['native'])} native batches, "
                                 f"{len(batches['python'])} Python batches")
        for i, (a, b) in enumerate(zip(batches["native"], batches["python"])):
            _same_batch(a, b, f"native: {what} batch {i}")
        log(f"native: {what} at batch {batch}: {len(batches['native'])} batches of the "
            f"native producer byte for byte the Python producer's; native "
            f"{seconds['native']:.4f} s per batch, Python {seconds['python']:.4f} s per batch "
            f"(host, the loader alone, {seconds['python'] / seconds['native']:.1f}x) | {card}")
        out[what] = dict(batches=len(batches["native"]), native_s_per_batch=seconds["native"],
                         python_s_per_batch=seconds["python"])
    return out


# ------------------------------------------------- preemption and resume

RESUME_SAVE_STEPS = 4      # the cut run's --save_steps
RESUME_SIGTERM_AT = 5      # SIGTERM while the cut run logs this step


class _SigtermAtStep(logging.Handler):
    """Delivers SIGTERM to this process when the pretraining loop logs step
    `step` of epoch 0: a preemption notice that arrives mid-epoch. The
    loop's handler then finishes the next step, checkpoints and returns."""

    def __init__(self, step):
        super().__init__()
        self.tag = f"epoch 0 step {step} "

    def emit(self, record):
        if record.getMessage().startswith(self.tag):
            os.kill(os.getpid(), signal.SIGTERM)


def _run_preempted(argv, step):
    from k3m_tpu_torch import pretrain
    loop_log = logging.getLogger("k3m_tpu_torch.train.pretrain_loop")
    handler, level = _SigtermAtStep(step), loop_log.level
    loop_log.addHandler(handler)
    loop_log.setLevel(logging.INFO)
    try:
        return pretrain.main(argv)
    finally:
        loop_log.removeHandler(handler)
        loop_log.setLevel(level)


def _state_diff(a, b):
    """(tensors compared, tensors not bit for bit equal, largest abs
    difference) over the parameters and AdamW moments of two trainers."""
    n = unequal = 0
    worst = 0.0
    named_b = dict(b.model.named_parameters())
    for name, p in a.model.named_parameters():
        q = named_b[name]
        pairs = [(p, q)] + [(a.opt.state[p][k], b.opt.state[q][k])
                            for k in ("exp_avg", "exp_avg_sq")]
        for x, y in pairs:
            n += 1
            if not torch.equal(x, y):
                unequal += 1
                worst = max(worst, float((x.float() - y.float()).abs().max()))
    return n, unequal, worst


def phase_resume(card):
    """Preemption and resume (batch 96, k3m_roberta_base at DEPTH_CUT, bf16)
    on phase 6's records, under torch.use_deterministic_algorithms (and the
    CUBLAS_WORKSPACE_CONFIG main sets): an uninterrupted epoch of
    TRAIN_STEPS steps; the same epoch cut by SIGTERM, with --save_steps; the
    run resumed from the cut run's latest.json. The resumed run's parameters
    and AdamW moments must equal the uninterrupted run's bit for bit. Where
    an op on the path has no deterministic implementation, it is named and
    the run repeated with warn_only; the tolerance is then 4 Adam steps of
    the learning rate (1e-4 each), since a last-bit difference in a gradient
    can flip the sign of an update whose moments are near zero."""
    from k3m_tpu_torch import kernels, pretrain
    from k3m_tpu_torch.train.state import CheckpointManager
    data_dir = WORK / "resume_data"
    cfg = write_cut_config(ROBERTA, data_dir)
    os.symlink(WORK / "pretrain_data" / "train_feat.k3mr", data_dir / "train_feat.k3mr")
    full_dir, cut_dir, resumed_dir = (WORK / f"resume_{k}" for k in ("full", "cut", "resumed"))
    nondeterministic = None
    kernels.reset_launch_counts()
    torch.use_deterministic_algorithms(True)
    try:
        try:
            full = pretrain.main(_pretrain_argv(data_dir, full_dir))
        except RuntimeError as e:
            if "deterministic" not in str(e):
                raise
            nondeterministic = str(e).splitlines()[0]
            log(f"resume: an op on the path has no deterministic implementation: "
                f"{nondeterministic}; repeating with warn_only")
            torch.use_deterministic_algorithms(True, warn_only=True)
            kernels.reset_launch_counts()
            full = pretrain.main(_pretrain_argv(data_dir, full_dir))
        shutil.rmtree(full_dir)
        cut = _run_preempted(_pretrain_argv(data_dir, cut_dir, "--save_steps",
                                            str(RESUME_SAVE_STEPS)), RESUME_SIGTERM_AT)
        last = cut["history"][-1]
        done = last.get("preempted_at_step")
        meta = CheckpointManager(str(cut_dir)).latest()
        if done != RESUME_SIGTERM_AT + 1 or meta != {
                "epoch": 0, "in_epoch_step": done, "dir": f"step_e0_s{done}"}:
            raise AssertionError(f"resume: the cut run ended {last} with latest.json {meta}")
        if not (cut_dir / f"step_e0_s{RESUME_SAVE_STEPS}" / "state.pt").exists():
            raise AssertionError(f"resume: no --save_steps checkpoint step_e0_s{RESUME_SAVE_STEPS}")
        step_gib = Path(last["checkpoint_path"], "state.pt").stat().st_size / 2 ** 30
        resumed = pretrain.main(_pretrain_argv(data_dir, resumed_dir, "--file_checkpoint",
                                               str(cut_dir)))
    finally:
        torch.use_deterministic_algorithms(False)
    counts = kernels.launch_counts()
    for d in (cut_dir, resumed_dir, data_dir):
        shutil.rmtree(d)
    (hist,) = resumed["history"]
    if resumed["resumed"] is None or resumed["resumed"]["step"] != done \
            or len(hist["step_seconds"]) != TRAIN_STEPS - done:
        raise AssertionError(f"resume: resumed {resumed['resumed']} ran "
                             f"{len(hist['step_seconds'])} steps")
    expected = expected_train_launches(cfg, 2 * TRAIN_STEPS)
    for name, want in expected.items():
        if counts[name] != want:
            raise AssertionError(f"resume: {name}: {counts[name]} launches, expected {want}")
    a, b = full["trainer"], resumed["trainer"]
    if (a.step, a._micro) != (b.step, b._micro):
        raise AssertionError(f"resume: step {b.step} against {a.step}")
    n, unequal, worst = _state_diff(a, b)
    tol = 0.0 if nondeterministic is None else 4 * 1e-4
    log(f"resume: SIGTERM while step {RESUME_SIGTERM_AT} logged; the cut run checkpointed "
        f"after step {done} ({step_gib:.2f} GiB in {last['checkpoint_seconds']:.2f} s, "
        f"--save_steps {RESUME_SAVE_STEPS} too) and returned; the resumed run restored it in "
        f"{resumed['resumed']['seconds']:.2f} s and ran steps {done + 1}-{TRAIN_STEPS}: "
        f"{n - unequal} of {n} parameters and AdamW moments bit for bit the uninterrupted "
        f"run's, largest difference {worst:.3e} (tolerance {tol:.1e}, "
        f"{'bit for bit under torch.use_deterministic_algorithms' if nondeterministic is None else 'an op without a deterministic implementation: ' + nondeterministic}) "
        f"| {card}")
    if worst > tol or (nondeterministic is None and unequal):
        raise AssertionError(f"resume: {unequal} tensors differ, largest {worst:.3e} > {tol}")
    res = dict(preempted_at_step=done, step_checkpoint_gib=step_gib,
               step_checkpoint_s=last["checkpoint_seconds"],
               restore_s=resumed["resumed"]["seconds"], tensors=n, unequal=unequal,
               max_abs_diff=worst, tolerance=tol, nondeterministic_op=nondeterministic,
               launches=counts)
    del full, cut, resumed, a, b
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------- pretrain -> finetune

def phase_chain(card):
    """`finetune --do_train --loss_type inner --file_state_dict` phase 6's
    model file (k3m_roberta_base), learning rate 0, on the validation pairs
    of phase 8 (2 steps): every weight of the alignment model is the
    file's, bit for bit; the pretraining heads are ignored."""
    from k3m_tpu_torch import finetune, kernels
    from k3m_tpu_torch.config import K3MConfig
    model_file = WORK / "pretrain_out" / "epoch_0" / "pytorch_model.bin"
    out_dir = WORK / "chain_out"
    argv = ["--data_dir", str(WORK / "finetune_data"), "--output_dir", str(out_dir),
            "--file_train", "valid_item_alignment.k3mr", "--config_file",
            "bert_base_6layer_6conect.json", "--use_image", "--with_coattention",
            "--do_train", "--bf16", "--loss_type", "inner", "--if_pre_sampling", "1",
            "--train_batch_size", str(FT_BATCH), "--learning_rate", "0",
            "--num_train_epochs", "1", "--seed", str(SEED), "--log_steps", "1",
            "--file_state_dict", str(model_file)]
    for k, v in SHAPES.items():
        argv += [f"--{k}", str(v)]
    kernels.reset_launch_counts()
    run = finetune.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    (hist,) = run["history"]
    steps = len(hist["step_seconds"])
    expected = expected_finetune_launches(K3MConfig.from_json_file(str(BERT)), steps, 0)
    for name, want in expected.items():
        if counts[name] != want or counts[name] == 0:
            raise AssertionError(f"chain: {name}: {counts[name]} launches, expected {want}")
    if not all(math.isfinite(x) for x in hist["step_losses"]):
        raise AssertionError(f"chain: non-finite losses {hist['step_losses']}")
    want = torch.load(model_file, map_location="cpu", weights_only=True)
    got = run["trainer"].model.state_dict()
    missing = sorted(set(got) - set(want))
    if missing:
        raise AssertionError(f"chain: the model file lacks {missing[:4]}")
    differ = [k for k, v in got.items() if not torch.equal(v.cpu(), want[k])]
    if differ:
        raise AssertionError(f"chain: {len(differ)} weights differ from the file: {differ[:4]}")
    res = dict(weights=len(got), ignored=len(want) - len(got), launches=counts)
    log(f"chain: finetune (loss inner, lr 0, {steps} steps of {FT_BATCH}) from phase 6's "
        f"{model_file.stat().st_size / 2 ** 30:.2f} GiB model file: all {len(got)} weights bit "
        f"for bit the file's, {res['ignored']} pretraining tensors ignored | {card}")
    del run, got
    shutil.rmtree(out_dir)
    shutil.rmtree(WORK / "pretrain_out")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------- int8 wire

def phase_wire(card):
    """One full-width bf16 train step with the int8 wire against the exact
    wire: same weights, batch and draws; losses within rtol 2e-2 (the JAX
    package's bound, tests/test_wire.py). The host->card bytes of the
    batch under each wire."""
    from k3m_tpu_torch import kernels
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.train.pretrain_loop import BATCH_KEYS, PretrainTrainer
    from k3m_tpu_torch.train.trainer import wire_batch
    from k3m_tpu_torch.train.wire import wire_bytes
    cfg = K3MConfig.from_json_file(str(ROBERTA)).replace(use_image=True, objective=2,
                                                         dtype="bfloat16")
    batch = next(iter(_pretrain_loader(WORK / "pretrain_data" / "train_feat.k3mr", cfg,
                                       TRAIN_BATCH, shuffle=True)))
    sizes = {m: wire_bytes(wire_batch(batch, BATCH_KEYS, cfg, m)) for m in ("fp", "int8",
                                                                          "exact")}
    losses = {}
    kernels.reset_launch_counts()
    for mode in ("exact", "int8"):
        trainer = PretrainTrainer(cfg, device="cuda", seed=SEED, objective=2, wire=mode)
        losses[mode] = {k: float(v) for k, v in trainer.train_step(batch).items()}
        del trainer
        torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    expected = expected_train_launches(cfg, 2)
    for name, want in expected.items():
        if counts[name] != want:
            raise AssertionError(f"wire: {name}: {counts[name]} launches, expected {want}")
    got, want = losses["int8"]["loss"], losses["exact"]["loss"]
    if not (math.isfinite(got) and abs(got - want) <= 2e-2 * abs(want)):
        raise AssertionError(f"wire: loss int8 {got} against exact {want}")
    rel = {k: abs(losses["int8"][k] - v) / max(abs(v), 1e-30)
           for k, v in losses["exact"].items() if v}
    log(f"wire: one train step of {TRAIN_BATCH}: loss int8 {got:.6f}, exact {want:.6f} "
        f"(rtol 2e-2; each term's relative difference {({k: f'{v:.2e}' for k, v in rel.items()})}); host->card "
        f"bytes per batch: fp {sizes['fp'] / 1e6:.2f} MB, int8 {sizes['int8'] / 1e6:.2f} MB, "
        f"exact {sizes['exact'] / 1e6:.2f} MB | {card}")
    return dict(losses=losses, wire_bytes=sizes, launches=counts)


# -------------------------------------------------------- device cache

CACHE_BATCHES = 3          # batches of the device-cache phase's epoch


def phase_cache(card):
    """`k3m_tpu_torch.pretrain --device_cache`, two epochs of CACHE_BATCHES
    batches of 96 (k3m_roberta_base at DEPTH_CUT): the first streams and keeps its staged
    batches, the second replays them; the kept batches equal, bit for bit,
    the first epoch's batches staged again from the loader."""
    from k3m_tpu_torch import kernels, pretrain
    data_dir, out_dir = WORK / "cache_data", WORK / "cache_out"
    cfg = write_cut_config(ROBERTA, data_dir)
    write_pretrain_records(data_dir / "train_feat.k3mr", CACHE_BATCHES * TRAIN_BATCH,
                           seed=SEED + 3)
    kernels.reset_launch_counts()
    run = pretrain.main(_pretrain_argv(data_dir, out_dir, "--device_cache", epochs=2))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    shutil.rmtree(out_dir)
    expected = expected_train_launches(cfg, 2 * CACHE_BATCHES)
    for name, want in expected.items():
        if counts[name] != want:
            raise AssertionError(f"cache: {name}: {counts[name]} launches, expected {want}")
    first, second = run["history"]
    if first["device_cache"]["from_cache"] or not second["device_cache"]["from_cache"]:
        raise AssertionError(f"cache: epochs read from the cache: "
                             f"{[h['device_cache'] for h in run['history']]}")
    trainer = run["trainer"]
    kept = trainer.epoch_cache._cache
    loader = _pretrain_loader(data_dir / "train_feat.k3mr", cfg, TRAIN_BATCH, shuffle=True)
    streamed = [trainer.stage(b) for b in loader]         # epoch 0 again
    torch.cuda.synchronize()
    if not len(kept) == len(streamed) == CACHE_BATCHES:
        raise AssertionError(f"cache: {len(kept)} kept, {len(streamed)} streamed batches")
    n = 0
    for i, (a, b) in enumerate(zip(kept, streamed)):
        if a.keys() != b.keys():
            raise AssertionError(f"cache: batch {i} keys differ")
        for k in a:
            if not (a[k].device == trainer.device and a[k].dtype == b[k].dtype
                    and torch.equal(a[k], b[k])):
                raise AssertionError(f"cache: batch {i} {k} differs from the streamed one")
            n += 1
    rates = [sum(h["step_samples"][1:]) / sum(h["step_seconds"][1:]) for h in run["history"]]
    info = second["device_cache"]
    log(f"cache: epoch 2 replayed {len(kept)} batches ({n} tensors bit for bit the streamed "
        f"epoch's) from {info['bytes'] / 1e6:.1f} MB on the card of a "
        f"{info['budget_bytes'] / 1e6:.0f} MB budget; {rates[0]:.2f} samples/s streamed, "
        f"{rates[1]:.2f} cached (steps 2-{CACHE_BATCHES} of each epoch) | {card}")
    res = dict(cached_bytes=info["bytes"], budget_bytes=info["budget_bytes"],
               samples_per_s=rates, tensors=n, launches=counts)
    del run, trainer, kept, streamed
    shutil.rmtree(data_dir)
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------ extraction phases

EXTRACT_SIZES = ((480, 640), (640, 480), (375, 500), (1200, 1600), (500, 1500))
EXTRACT_IMAGES = 16
EXTRACT_BATCH = 4          # the CLI's --extract_batch_size default
EXTRACT_CANVAS = (600, 800)  # the canvas of the stage-timed batch
CROSS_MIN_MAX = (240, 400)   # the card-vs-CPU image's min/max size


def write_ppm(path, bgr):
    """Binary PPM (P6, RGB order) from a BGR uint8 image: the card's host
    has no cv2, and the port reads PPM without it."""
    h, w = bgr.shape[:2]
    path.write_bytes(b"P6\n%d %d\n255\n" % (w, h) + bgr[:, :, ::-1].tobytes())


def write_extract_inputs(d):
    """The seeded detectron2-layout pkl at the published 1600 classes
    (frcnn.synthetic_caffe_state_dict, whose construction makes the
    selection run), EXTRACT_IMAGES PPM images cycling through
    EXTRACT_SIZES, and their item_info jsonl. -> raw (h, w) per image."""
    import pickle

    from k3m_tpu_torch.vision import frcnn
    (d / "images").mkdir(parents=True, exist_ok=True)
    with open(d / "frcnn.pkl", "wb") as f:
        pickle.dump({"model": frcnn.synthetic_caffe_state_dict(frcnn.NUM_CLASSES, SEED)}, f)
    rng = np.random.default_rng(SEED + 7)
    sizes, lines = [], []
    for i in range(EXTRACT_IMAGES):
        h, w = EXTRACT_SIZES[i % len(EXTRACT_SIZES)]
        write_ppm(d / "images" / f"{i}.ppm", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        sizes.append((h, w))
        lines.append(json.dumps(dict(item_id=f"x{i}", item_image_name=f"{i}.ppm",
                                     title=f"商品{i} 红色 连衣裙", item_pvs="颜色#:#红#;#尺码#:#M",
                                     cate_name="女装"), ensure_ascii=False))
    (d / "item_info.jsonl").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return sizes


def check_extract_records(path, sizes):
    """Every record: 0-36 boxes inside its raw image, finite [n, 2048]
    features, cls_prob rows [n, 1601] summing to 1 (within 1e-4); at least
    half of the images at 36 boxes. -> box counts."""
    from k3m_tpu_torch.data.records import RecordReader
    reader = RecordReader(str(path))
    if len(reader) != len(sizes):
        raise AssertionError(f"extract: {len(reader)} records for {len(sizes)} images")
    counts = []
    for i, (h, w) in enumerate(sizes):
        r = reader[i]
        n = int(r["num_boxes"])
        counts.append(n)
        if not 0 <= n <= 36 or (r["image_h"], r["image_w"]) != (h, w):
            raise AssertionError(f"extract: record {i}: {n} boxes, size "
                                 f"{(r['image_h'], r['image_w'])} for {(h, w)}")
        feats, probs, boxes = r["features"], r["cls_prob"], r["boxes"]
        if feats.shape != (n, 2048) or not np.isfinite(feats).all():
            raise AssertionError(f"extract: record {i}: features {feats.shape}, finite "
                                 f"{np.isfinite(feats).all()}")
        if probs.shape != (n, 1601) or (n and np.abs(probs.sum(-1) - 1).max() > 1e-4):
            raise AssertionError(f"extract: record {i}: cls_prob {probs.shape}")
        if n and ((boxes < 0).any() or (boxes[:, [0, 2]] > w).any()
                  or (boxes[:, [1, 3]] > h).any()):
            raise AssertionError(f"extract: record {i}: a box outside {w}x{h}")
    reader.close()
    if 2 * sum(n == 36 for n in counts) < len(counts):
        raise AssertionError(f"extract: fewer than half the images at 36 boxes: {counts}")
    return counts


def _conv_linear_macs(module, *inputs):
    """MACs of the Conv2d and Linear layers `module` runs on `inputs`
    (shapes only: run on the meta device)."""
    total = 0

    def hook(layer, args, out):
        nonlocal total
        if isinstance(layer, torch.nn.Conv2d):
            k = layer.in_channels * layer.kernel_size[0] * layer.kernel_size[1]
        else:
            k = layer.in_features
        total += out.numel() * k

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    out = module(*inputs)
    for h in hooks:
        h.remove()
    return total, out


def extract_stage_bounds(B, ch, cw):
    """Per stage of one batch of B images in a ch x cw canvas: the least
    time the card could take (the larger of the stage's bytes, each input
    read once and each output written once, over 3.35 TB/s, and its fp32
    operations over 67 TFLOP/s), and which bounds it."""
    from k3m_tpu_torch.vision import frcnn
    f4 = 4
    with torch.device("meta"):
        m = frcnn.FasterRCNN()
        weights = {n: p.numel() * f4 for n, p in m.state_dict().items()}
        bb_macs, feat = _conv_linear_macs(m.backbone, torch.empty(B, 3, ch, cw))
        rpn_macs, _ = _conv_linear_macs(m.proposal_generator.rpn_head, feat)
        N, C = frcnn.POST_NMS_TOPK, frcnn.NUM_CLASSES
        r5_macs, _ = _conv_linear_macs(m.roi_heads.res5, torch.empty(B * N, 1024, 14, 14))
        pred_macs, _ = _conv_linear_macs(m.roi_heads.box_predictor, torch.empty(B * N, 2048))
    fh, fw = feat.shape[2:]
    A = fh * fw * 15
    wsum = lambda prefix: sum(v for n, v in weights.items() if n.startswith(prefix))
    feat_b = B * 1024 * fh * fw * f4
    pooled_b = B * N * 1024 * 14 * 14 * f4
    stage = {
        "backbone": (B * 3 * ch * cw * f4 + wsum("backbone") + feat_b, 2 * bb_macs),
        "rpn": (feat_b + wsum("proposal_generator") + B * A * 5 * f4, 2 * rpn_macs),
        "proposal_nms": (B * A * 5 * f4 + B * N * 5 * f4, 0),
        "roi_pool": (feat_b + B * N * 4 * f4 + pooled_b, 0),
        "res5": (pooled_b + wsum("roi_heads.res5") + B * N * 2048 * f4, 2 * r5_macs),
        "predictor": (B * N * 2048 * f4 + wsum("roi_heads.box_predictor")
                      + B * N * ((C + 1) + C * 4) * f4, 2 * pred_macs),
        "selection": (B * N * ((C + 1) + C * 4 + 2048) * f4
                      + B * 36 * (4 + 2048 + C + 1) * f4, 0),
    }
    out = {}
    for name, (nbytes, ops) in stage.items():
        t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS[torch.float32]
        out[name] = dict(bound_ms=max(t_bytes, t_ops), bound_by="operations"
                         if t_ops > t_bytes else "bytes", bytes=nbytes, flops=ops)
    return out


def time_extract_stages(extractor, images, reps=3):
    """Stream ms between CUDA events recorded after each stage (the
    extractor's stage hook) of extract_many on one batch, the peak memory
    each stage allocated beyond what was allocated before the call, and
    the host's wall ms of the call; the runs after the first, averaged."""
    marks = []
    base = torch.cuda.memory_allocated()

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev, torch.cuda.max_memory_allocated() - base))
        torch.cuda.reset_peak_memory_stats()

    extractor.stage_hook = hook
    runs = []
    try:
        for _ in range(reps):
            marks.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            dets = extractor.extract_many(images)
            wall = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            ms, peak, prev = {}, {}, start
            for stage, ev, mem in marks:
                ms[stage], peak[stage], prev = prev.elapsed_time(ev), mem / 2 ** 30, ev
            runs.append((ms, peak, wall))
    finally:
        extractor.stage_hook = None
    if any(d is None for d in dets):
        raise AssertionError("extract: an image of the timed batch yielded no boxes")
    later = runs[1:]
    ms = {k: sum(r[0][k] for r in later) / len(later) for k in later[0][0]}
    peak = {k: max(r[1][k] for r in later) for k in later[0][1]}
    return ms, peak, sum(r[2] for r in later) / len(later), runs[0][0]


def phase_extract(card):
    """`k3m_tpu_torch.data.prepare --item_info --image_dir --extract_features
    --extract_batch_size 4 --frcnn_weights` on the card at the full
    configuration (R101-C4, 600/1000, 6000 -> 300 proposals, 1601 classes,
    36 objects, fp32 with TF32 off, bucket 200) over EXTRACT_IMAGES images
    of mixed sizes; the records checked and read by the port's
    PretrainLoader; then one batch of 4 images in one canvas timed stage by
    stage and profiled."""
    from k3m_tpu_torch import kernels
    from k3m_tpu_torch.data import prepare
    from k3m_tpu_torch.data.pipeline import PretrainLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.tokenization import get_tokenizer
    from k3m_tpu_torch.vision import frcnn

    d = WORK / "extract"
    t0 = time.perf_counter()
    sizes = write_extract_inputs(d)
    log(f"extract: wrote the seeded pkl ({(d / 'frcnn.pkl').stat().st_size / 2 ** 20:.0f} "
        f"MiB) and {len(sizes)} PPM images of sizes {sorted(set(sizes))} in "
        f"{time.perf_counter() - t0:.1f} s")
    out = d / "train_feat.k3mr"
    argv = ["--item_info", str(d / "item_info.jsonl"), "--image_dir", str(d / "images"),
            "--extract_features", "--extract_batch_size", str(EXTRACT_BATCH),
            "--frcnn_weights", str(d / "frcnn.pkl"), "--output", str(out)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # what earlier phases still hold
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run = prepare.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ex = run["extractor"]
    if ex.fallbacks:
        raise AssertionError(f"extract: {ex.fallbacks} images went through the "
                             "per-image fallback")
    launches = kernels.launch_counts()
    if any(launches.values()):                # none of the five lies on this path
        raise AssertionError(f"extract: a port kernel ran: {launches}")
    flushes = ex.flush_seconds
    images_per_s = sum(n for n, _ in flushes[1:]) / sum(s for _, s in flushes[1:])
    counts = check_extract_records(out, sizes)
    canvases = sorted({ex._canvas_hw(*frcnn.resize_shape(h, w)) for h, w in sizes})
    log(f"extract: {run['records']} records in {wall:.2f} s (model load included); "
        f"{images_per_s:.2f} images/s over flushes 2-{len(flushes)} of {EXTRACT_BATCH} "
        f"(flush seconds {[round(s, 3) for _, s in flushes]}; canvases {canvases}); "
        f"boxes per image {counts}; no fallback; peak memory {peak:.2f} GiB beyond the "
        f"{base / 2 ** 30:.2f} GiB allocated before | {card}")

    loader = PretrainLoader(str(out), get_tokenizer(), ShapeSpec(), batch_size=EXTRACT_BATCH,
                            shuffle=False)
    batch = next(iter(loader))
    if (batch["image_feat"].shape != (EXTRACT_BATCH, 37, 2048)
            or not np.isfinite(batch["image_feat"]).all()
            or list(batch["image_mask"].sum(1)) != [n + 1 for n in counts[:EXTRACT_BATCH]]):
        raise AssertionError("extract: the PretrainLoader's batch does not hold the records")
    log(f"extract: the port's PretrainLoader ({loader.producer} producer) read a batch of "
        f"{EXTRACT_BATCH}: image_feat {tuple(batch['image_feat'].shape)}, regions "
        f"{list(batch['image_mask'].sum(1))}")

    same = [i for i, (h, w) in enumerate(sizes)
            if ex._canvas_hw(*frcnn.resize_shape(h, w)) == EXTRACT_CANVAS][:EXTRACT_BATCH]
    images = [frcnn.read_image(str(d / "images" / f"{i}.ppm")) for i in same]
    ms, stage_peak, wall_ms, first = time_extract_stages(ex, images)
    bounds = extract_stage_bounds(len(images), *EXTRACT_CANVAS)
    busy = sum(ms.values())
    log(f"extract: one batch of {len(images)} images in a {EXTRACT_CANVAS} canvas: "
        f"{1e3 * len(images) / wall_ms:.2f} images/s ({wall_ms:.2f} ms a call, "
        f"stream {busy:.2f} ms) | {card}")
    for stage, t in ms.items():
        b = bounds.get(stage)
        log(f"extract: stage {stage}: {t:.3f} ms (first run {first[stage]:.3f}), peak "
            f"{stage_peak[stage]:.2f} GiB"
            + (f", bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
               f"({b['flops'] / 1e9:.1f} GFLOP, {b['bytes'] / 1e9:.3f} GB)" if b else ""))
    prof = profile_device(lambda: ex.extract_many(images), card,
                          f"extract_many of {len(images)} images", n=1)
    log(f"extract: {prof['host_launch_calls']} kernel launches per batch of {len(images)}, "
        f"busy share {1 - prof['idle_share']:.3f} | {card}")
    res = dict(records=run["records"], wall_s=wall, images_per_s=images_per_s,
               flush_seconds=flushes, boxes=counts, peak_gib=peak, canvases=canvases,
               batch=dict(images=len(images), canvas=EXTRACT_CANVAS, stage_ms=ms,
                          first_stage_ms=first, stage_peak_gib=stage_peak, wall_ms=wall_ms,
                          images_per_s=1e3 * len(images) / wall_ms, bounds=bounds,
                          roi_chunk=int(os.environ.get("K3M_ROI_CHUNK", "32"))),
               profile=prof, launches_per_batch=prof["host_launch_calls"],
               launches=launches)
    del run, ex, loader
    torch.cuda.empty_cache()
    return res


def _rel(a, b):
    """Largest difference over the larger of b's scale and 1e-6."""
    return max_err(a, b.to(a.device)) / max(float(b.abs().max()), 1e-6)


def phase_extract_crosscheck(card):
    """One image (phase 15's first, min/max size CROSS_MIN_MAX) through the
    same weights on the card and on the CPU, stage by stage, fp32 with TF32
    off on both (frcnn.inference scopes cuDNN's; matmuls are full fp32):
    the backbone map, the RPN logits and deltas, the pooled RoI features
    (both pooling the card's proposals), the box features and the class
    probabilities within 1e-4 of their scale (fp32 sums in another order
    through ~110 layers; the first run read at most 3.1e-6); then the discrete stages (the stable top-k, the
    proposal NMS, the class NMS sweep) run on the CPU from the card's
    continuous tensors equal the card's index for index."""
    from k3m_tpu_torch.vision import frcnn

    d = WORK / "extract"
    pkl = str(d / "frcnn.pkl")
    gpu, cpu = frcnn.build_model(pkl, "cuda"), frcnn.build_model(pkl, "cpu")
    raw = frcnn.read_image(str(d / "images" / "0.ppm"))
    errs, worst = {}, 0.0
    with frcnn.inference():
        x = frcnn.preprocess(raw, "cuda", *CROSS_MIN_MAX)[None]
        hw = torch.tensor([x.shape[2:]], dtype=torch.float32, device="cuda")
        feat, feat_h = gpu.backbone(x), cpu.backbone(x.cpu())
        errs["backbone map"] = _rel(feat_h, feat)
        fh, fw = feat.shape[2:]
        (logits, deltas), (logits_h, deltas_h) = gpu.rpn_outputs(feat), cpu.rpn_outputs(feat_h)
        errs["rpn logits"], errs["rpn deltas"] = _rel(logits_h, logits), _rel(deltas_h, deltas)
        scores, proposals = gpu.decode_proposals(logits, deltas, hw, fh, fw)
        boxes, valid = frcnn.select_proposals(scores, proposals)
        order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
        order_h = torch.sort(scores.cpu(), dim=-1, descending=True, stable=True)[1]
        boxes_h, valid_h = frcnn.select_proposals(scores.cpu(), proposals.cpu())
        pooled, pooled_h = gpu.pool(feat, boxes), cpu.pool(feat_h, boxes.cpu())
        errs["pooled"] = _rel(pooled_h, pooled)
        bf, bf_h = gpu.box_features(pooled), cpu.box_features(pooled_h)
        errs["box features"] = _rel(bf_h, bf)
        probs, cls_boxes = gpu.predict(bf, boxes, hw)
        probs_h, _ = cpu.predict(bf_h, boxes.cpu(), hw.cpu())
        errs["probs"] = _rel(probs_h, probs)
        outputs = dict(probs=probs, boxes=cls_boxes, features=bf)
        sel = frcnn._select_instances(outputs, valid)
        sel_h = frcnn._select_instances({k: v.cpu() for k, v in outputs.items()}, valid.cpu())
    for what, e in errs.items():
        worst = max(worst, e)
        if not e <= 1e-4:
            raise AssertionError(f"extract crosscheck: {what} differs by {e:.3e} of its scale")
    k = min(frcnn.PRE_NMS_TOPK, order.shape[-1])
    discrete = dict(top_k=torch.equal(order[:, :k].cpu(), order_h[:, :k]),
                    proposal_nms=torch.equal(boxes.cpu(), boxes_h)
                    and torch.equal(valid.cpu(), valid_h),
                    selection=all(torch.equal(sel[key].cpu(), sel_h[key])
                                  for key in ("boxes", "scores", "rows", "valid")))
    n_sel = int(sel["valid"].sum())
    log(f"extract crosscheck: {x.shape[2]}x{x.shape[3]} image, card vs CPU, fp32, TF32 off: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" of the scale (limit 1e-4); discrete stages on the CPU from the card's tensors "
          f"equal the card's: {discrete} ({int(valid.sum())} proposals, {n_sel} boxes "
          f"selected) | {card}")
    if not all(discrete.values()) or n_sel == 0:
        raise AssertionError(f"extract crosscheck: discrete stages differ {discrete}, "
                             f"{n_sel} boxes")
    del gpu, cpu          # phase 20 reads phase 15's inputs and records, then deletes them
    torch.cuda.empty_cache()
    return dict(errors=errs, worst=worst, discrete=discrete, proposals=int(valid.sum()),
                selected=n_sel, image=tuple(x.shape[2:]))


# ------------------------------------------- data-parallel phases (17-19)

DP_TIMEOUT_S = 420          # a phase whose ranks run longer has hung
DP_STEPS = 3                # phase 17's steps, the first a warm-up
DP_BF16_TOL = 2.0 ** -6     # bf16: the kernels' tolerance of phase 3, of max(1, |x|)
WORLD_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "K3M_COORDINATOR_ADDRESS", "K3M_NUM_PROCESSES", "K3M_PROCESS_ID",
              "K3M_DIST_BACKEND", "K3M_DIST_INIT_TIMEOUT")


# the depth of the runs that check how ranks and runs agree (phases 11,
# 14, 17, 18, 21's comparison, defaults and raw TSV, 22's two-rank steps,
# 23), so that the script stays inside its time: the shipped
# configs' widths and heads, 4 text layers, 2 image layers and 2
# co-attention blocks of each kind
DEPTH_CUT = dict(num_hidden_layers=4, v_num_hidden_layers=2, v_biattention_id=[0, 1],
                 t_biattention_id=[2, 3])


def write_cut_config(src, dest_dir):
    """The shipped config `src` at DEPTH_CUT, written under its own name
    into `dest_dir` (a data dir: `pretrain` and `train_concap_struc` look
    there before the package's configs/; `finetune` is given its path);
    returns it."""
    from k3m_tpu_torch.config import K3MConfig
    d = dict(json.loads(Path(src).read_text()), **DEPTH_CUT)
    Path(dest_dir).mkdir(parents=True, exist_ok=True)
    (Path(dest_dir) / Path(src).name).write_text(json.dumps(d, indent=1))
    return K3MConfig.from_dict(d)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_env(launch, rank=0, size=1, port=None, local_rank=0):
    """The environment of one rank: `plain` (no world), `torchrun` (its
    variables; NCCL on cuda:`local_rank`), or `gloo` (the JAX package's
    K3M_* variables and K3M_DIST_BACKEND=gloo, LOCAL_RANK 0 for every
    rank: the ranks share the one card)."""
    env = {k: v for k, v in os.environ.items() if k not in WORLD_VARS}
    if launch == "torchrun":
        env.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(local_rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    elif launch == "gloo":
        env.update(K3M_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", K3M_NUM_PROCESSES=str(size),
                   K3M_PROCESS_ID=str(rank), LOCAL_RANK="0", K3M_DIST_BACKEND="gloo")
    if launch != "plain":
        env["K3M_DIST_INIT_TIMEOUT"] = str(DP_TIMEOUT_S)
    return env


def run_workers(jobs, what, during=None):
    """Start every job (name, spec, env) as `python3 chip_smoke.py
    --dp-worker <spec>` at once, call `during()` (work of this process
    that overlaps theirs) and wait for all; each writes its result JSON,
    its log goes to chiprun_out/dp_<name>.log. Fails if one exits non-zero
    or the phase outlives DP_TIMEOUT_S; kills what still runs."""
    d = WORK / "dp"
    d.mkdir(parents=True, exist_ok=True)
    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    running = []
    try:
        for name, spec, env in jobs:
            spec_path, result = d / f"{name}.json", d / f"{name}.result.json"
            spec_path.write_text(json.dumps(dict(spec, result=str(result))))
            logf = open(OUT_JSON.parent / f"dp_{name}.log", "w")
            proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker",
                                     str(spec_path)], env=env, cwd=str(ROOT), stdout=logf,
                                    stderr=subprocess.STDOUT)
            running.append((name, proc, logf, result))
        deadline = time.monotonic() + DP_TIMEOUT_S
        if during is not None:
            during()
        for name, proc, _, _ in running:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{what}: {name} still running after {DP_TIMEOUT_S} s")
    finally:
        for _, proc, logf, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    out = {}
    for name, proc, _, result in running:
        if proc.returncode != 0 or not result.exists():
            tail = (OUT_JSON.parent / f"dp_{name}.log").read_text()[-3000:]
            raise AssertionError(f"{what}: {name} exited {proc.returncode}:\n{tail}")
        out[name] = json.loads(result.read_text())
    return out


def _sha(named):
    """sha256 of (name, tensor) pairs, bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for name, t in named:
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


AR_STEPS = 4    # train steps after a data-parallel finetune that time its all-reduce


def _dp_finetune(spec):
    """`k3m_tpu_torch.finetune` with the spec's argv, in the world its
    environment gives; under `profile`, one more train step on this rank's
    rows after the run is read (every rank steps, rank 0 under the
    profiler: device ms, launch calls and wall ms of that step). The
    kernels' launch counts (`launches`) are read then. Where the world has
    ranks to sum over, AR_STEPS more train steps follow, each recording
    (utils/trace.py) so that the span `k3m.allreduce` times its all-reduce
    between two device syncs: the history's `allreduce_seconds`. The run's
    own steps are not recorded, so their times are the program's alone."""
    from k3m_tpu_torch import finetune, kernels
    from k3m_tpu_torch.dist import World
    from k3m_tpu_torch.train import dist
    from k3m_tpu_torch.utils import trace
    held, init = [], dist.init_from_env

    # the CLI leaves its world at its end: keep it for the steps below
    def init_and_hold(*args, **kwargs):
        world = init(*args, **kwargs)
        world.close = lambda: None
        held.append(world)
        return world
    dist.init_from_env = init_and_hold
    try:
        run = finetune.main(spec["argv"])
    finally:
        dist.init_from_env = init
    out = dict(world=run["world"])
    if "history" in run:
        (h,) = run["history"]
        out["history"] = {k: h[k] for k in ("step_seconds", "step_pairs", "step_losses",
                                            "sweep", "allreduce_bytes", "checkpoint_path")
                          if k in h}
        out["params_sha"] = _sha(run["trainer"].model.named_parameters())
    if "output" in run:
        out.update(output=run["output"], batch_seconds=run["batch_seconds"],
                   batch_pairs=run["batch_pairs"])
    timed = "history" in run and bool(run["trainer"].world.group)
    if timed or spec.get("profile"):
        trainer = run["trainer"]
        path = Path(spec["argv"][spec["argv"].index("--data_dir") + 1])
        batch = trainer.stage(_load_batch(path / "train_item_alignment.k3mr", trainer.config,
                                          out["history"]["step_pairs"][0]))
        step = lambda: trainer.train_step(batch)
    if spec.get("profile"):
        out["profile"] = None
        if trainer.world.rank == 0:
            out["profile"] = profile_device(step, spec.get("card", ""), f"rank 0 of "
                                            f"{trainer.world.size}: finetune train step", n=1)
        else:
            step()
            torch.cuda.synchronize()
    out["launches"] = kernels.launch_counts()
    if timed:
        seconds = []
        for _ in range(AR_STEPS):
            with trace.recording():
                step()
            seconds.append(trainer.allreduce[1])
        out["history"]["allreduce_seconds"] = seconds
    if held:
        World.close(held[0])
    return out


def _dp_pretrain_step(spec):
    """One fp32 pretraining step (dropout on, the step's own draws) on this
    rank's rows (its data group's, under the spec's `n_model`) of the
    spec's global batch: the global losses, and the gradients after the
    all-reduce, gathered over the model group (rank 0 saves them)."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.random import StepRandom
    from k3m_tpu_torch.train import dist
    from k3m_tpu_torch.train.dist import all_reduce_grads
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    world = dist.init_from_env("cuda", spec.get("n_model", 1))
    try:
        cfg = K3MConfig.from_json_file(str(ROBERTA)).replace(use_image=True, objective=2,
                                                             **spec.get("cfg", {}))
        batch = torch.load(spec["batch"], weights_only=False)
        local = _batch_rows(batch, world.data_rank,
                            len(batch["input_ids"]) // world.data_size)
        trainer = PretrainTrainer(cfg, device=world.device, seed=SEED, objective=2, world=world)
        with recording_masks() as masks:
            loss, metrics = trainer.losses(trainer.stage(local), deterministic=False,
                                           rng=StepRandom(SEED, 0, world.device))
        if spec.get("masks"):
            torch.save(masks, f"{spec['masks']}.{world.rank}")
        loss.backward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = all_reduce_grads(world, trainer.model.parameters())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        metrics = trainer.global_metrics(metrics)
        grads = _full_grads(trainer.model, world)
        if world.rank == 0:
            torch.save(grads, spec["grads"])
        return dict(world=dict(rank=world.rank, size=world.size, backend=world.backend),
                    losses={k: float(v) for k, v in metrics.items()},
                    grads_sha=_sha(grads.items()), allreduce_bytes=nbytes,
                    allreduce_s=seconds, traffic=world.traffic)
    finally:
        world.close()


@contextlib.contextmanager
def recording_masks():
    """[(head0, mask words on the host)] of every attention and
    bi-attention forward kernel call that keeps mask words (its backward
    follows), in call order, while the enclosed code runs."""
    from k3m_tpu_torch.kernels import attention, coattn
    store, fwd_a, fwd_c = [], attention._forward, coattn._forward

    def self_attention(*a, **kw):
        out = fwd_a(*a, **kw)
        if out[2] is not None:
            store.append((kw.get("head0", 0), out[2].cpu()))
        return out

    def biattention(*a, **kw):
        out = fwd_c(*a, **kw)
        store.extend((kw.get("head0", 0), words.cpu()) for _, words in out[2:]
                     if words is not None)
        return out
    attention._forward, coattn._forward = self_attention, biattention
    try:
        yield store
    finally:
        attention._forward, coattn._forward = fwd_a, fwd_c


DP_MODES = {"finetune": _dp_finetune, "pretrain_step": _dp_pretrain_step,
            "finetune_step": lambda spec: _tp_finetune_step(spec),
            "cli": lambda spec: _tp_cli(spec)}


def dp_worker(spec_path):
    """One process of phases 17-19 and 22-23 (`chip_smoke.py --dp-worker
    <spec>`):
    the spec's mode, with the kernels' launch counts (unless the mode read
    them) and the peak memory of this process; under `deterministic`, with
    torch.use_deterministic_algorithms (warn_only: an op without a
    deterministic implementation is reported, not raised)."""
    import warnings
    from k3m_tpu_torch import kernels
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if spec.get("deterministic"):
            torch.use_deterministic_algorithms(True, warn_only=True)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = DP_MODES[spec["mode"]](spec)
        torch.cuda.synchronize()
    out.setdefault("launches", kernels.launch_counts())
    out.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               nondeterministic=sorted({str(w.message).splitlines()[0] for w in caught
                                        if "deterministic" in str(w.message)}))
    Path(spec["result"]).write_text(json.dumps(out))
    return 0


def _finetune_dp_argv(out_dir, *extra, data_dir=None, batch=FT_BATCH):
    """Phase 8's argv (run_finetune_item_alignment.sh's flags, global batch
    `batch`) on phase 8's records (or those in `data_dir`), into
    `out_dir`."""
    argv = ["--data_dir", str(data_dir or WORK / "finetune_data"), "--output_dir",
            str(out_dir),
            "--config_file", "bert_base_6layer_6conect.json", "--use_image",
            "--with_coattention", "--do_train", "--do_eval", "--bf16", "--loss_type", "inner",
            "--if_pre_sampling", "1", "--train_batch_size", str(batch),
            "--eval_batch_size", str(batch), "--learning_rate", "5e-5",
            "--warmup_proportion", "0.3", "--num_train_epochs", "1", "--seed", str(SEED),
            "--log_steps", "1", *extra]
    for k, v in SHAPES.items():
        argv += [f"--{k}", str(v)]
    return argv


class _RankOrder:
    """The global batches of a run over `loaders` (one per rank), as one
    process sees them: rank r's batch i, concatenated in rank order (the
    layout of the JAX package's make_array_from_process_local_data)."""

    def __init__(self, loaders):
        self.loaders = loaders

    @property
    def epoch(self):
        return self.loaders[0].epoch

    @epoch.setter
    def epoch(self, value):
        for ld in self.loaders:
            ld.epoch = value

    def __iter__(self):
        def cat(parts):
            if isinstance(parts[0], dict):
                return {k: cat([p[k] for p in parts]) for k in parts[0]}
            if isinstance(parts[0], list):
                return sum(parts, [])
            return np.concatenate(parts)
        for parts in zip(*self.loaders):
            yield cat(list(parts))


def rank_order_losses(cfg, world_size, data_dir=None):
    """The step losses of one process training, as the finetune CLI does,
    on the global batches of a `world_size`-rank run (_RankOrder) over the
    training pairs in `data_dir` (phase 8's by default), on the current
    card."""
    from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer
    path = (data_dir or WORK / "finetune_data") / "train_item_alignment.k3mr"
    loaders = [_loader(path, cfg, FT_BATCH // world_size, shuffle=True, drop_last=True,
                       num_shards=world_size, shard_index=r) for r in range(world_size)]
    total = len(loaders[0])
    trainer = AlignmentTrainer(cfg, learning_rate=5e-5, warmup_steps=int(0.3 * total),
                               total_steps=total, seed=SEED, device="cuda")
    (hist,) = trainer.fit(_RankOrder(loaders), num_epochs=1, log_steps=0)
    del trainer
    torch.cuda.empty_cache()
    return hist["step_losses"]


def phase_dp_train(card):
    """Phase 8's finetune (bf16, dropout 0.1, global batch 32, DP_STEPS
    steps over its own records and the sweep; bert_base_6layer_6conect at
    DEPTH_CUT) three ways, all at once: one plain process and a world of
    one over NCCL (torchrun's variables), both under
    torch.use_deterministic_algorithms; two ranks sharing the card over
    gloo (the K3M_* variables, LOCAL_RANK 0 for both); and meanwhile this
    process trains on the same global batches. The NCCL world of
    one must equal the plain run bit for bit
    (losses, sweep, every parameter); the two ranks must end with
    bit-identical parameters and the same sweep, each having launched
    every kernel the per-step count times; their global losses must lie
    within DP_BF16_TOL of one process trained on the same global batches
    (rank 0's 16 pairs then rank 1's, as the JAX package lays them out;
    bf16, so sums in another order round apart)."""
    data = WORK / "dp_data"
    cfg = write_cut_config(BERT, data)
    write_finetune_records(data, DP_STEPS * FT_BATCH)
    argv = lambda out: _finetune_dp_argv(out, "--config_file", str(data / BERT.name),
                                         data_dir=data)
    det = dict(mode="finetune", deterministic=True)
    port = _free_port()
    ref = []                             # one process, while the ranks run
    got = run_workers([
        ("train_plain", dict(det, argv=argv(WORK / "dp_plain")), _dp_env("plain")),
        ("train_nccl1", dict(det, argv=argv(WORK / "dp_nccl1")),
         _dp_env("torchrun", 0, 1, _free_port()))]
        + [(f"train_gloo{r}", dict(mode="finetune", argv=argv(WORK / "dp_gloo")),
            _dp_env("gloo", r, 2, port)) for r in range(2)], "dp_train",
        during=lambda: ref.extend(rank_order_losses(cfg.replace(
            use_image=True, with_coattention=True, if_pre_sampling=1,
            loss_type="inner", dtype="bfloat16"), 2, data)))
    plain, nccl = got["train_plain"], got["train_nccl1"]
    ranks = [got["train_gloo0"], got["train_gloo1"]]
    if nccl["world"] != dict(rank=0, size=1, backend="nccl") or \
            [r["world"] for r in ranks] != [dict(rank=r, size=2, backend="gloo")
                                            for r in range(2)]:
        raise AssertionError(f"dp_train: worlds {nccl['world']} {[r['world'] for r in ranks]}")
    nondet = sorted(set(plain["nondeterministic"]) | set(nccl["nondeterministic"]))
    same = {k: plain["history"][k] == nccl["history"][k]
            for k in ("step_losses", "sweep")}
    same["params"] = plain["params_sha"] == nccl["params_sha"]
    log(f"dp_train: NCCL world of one against the plain run: {same} (bit for bit; ops "
        f"without a deterministic implementation: {nondet or 'none'}); gradient all-reduce "
        f"{nccl['history']['allreduce_bytes'][0] / 2 ** 30:.3f} GiB a step over NCCL in "
        f"{1e3 * np.mean(nccl['history']['allreduce_seconds'][1:]):.2f} ms | {card}")
    if not all(same.values()):
        raise AssertionError(f"dp_train: the NCCL world of one differs from the plain run: "
                             f"{same}; nondeterministic ops {nondet}")
    expected = expected_finetune_launches(cfg, DP_STEPS, 2)   # 2 sweep batches on each rank
    for name, res in [("plain", plain), ("nccl1", nccl), ("gloo rank 0", ranks[0]),
                      ("gloo rank 1", ranks[1])]:
        if any(res["launches"][k] != n for k, n in expected.items()):
            raise AssertionError(f"dp_train {name}: launches {res['launches']}, "
                                 f"expected {expected}")
    h0, h1 = ranks[0]["history"], ranks[1]["history"]
    if ranks[0]["params_sha"] != ranks[1]["params_sha"]:
        raise AssertionError("dp_train: the two ranks' final parameters differ")
    if h0["sweep"] != h1["sweep"] or h0["step_losses"] != h1["step_losses"]:
        raise AssertionError("dp_train: the two ranks report different sweeps or losses")
    if h0["step_pairs"] != [FT_BATCH // 2] * DP_STEPS:
        raise AssertionError(f"dp_train: rank 0 trained on {h0['step_pairs']} pairs")
    errs = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(h0["step_losses"], ref)]
    log(f"dp_train: two gloo ranks' global losses {[round(x, 4) for x in h0['step_losses']]} "
        f"against one process on the same global batches {[round(x, 4) for x in ref]}: "
        f"worst {max(errs):.3e} of max(1, |loss|) (tolerance {DP_BF16_TOL:.3e}); plain run "
        f"{[round(x, 4) for x in plain['history']['step_losses']]} (rank order differs, "
        f"so its draws fall on other pairs) | {card}")
    if len(ref) != DP_STEPS or max(errs) > DP_BF16_TOL:
        raise AssertionError(f"dp_train: two-rank losses off by {max(errs):.3e}")
    step_ms = [1e3 * t for t in h0["step_seconds"][1:]]
    pairs_per_s = 2 * sum(h0["step_pairs"][1:]) / sum(h0["step_seconds"][1:])
    ar_ms = [1e3 * t for t in h0["allreduce_seconds"][1:]]
    ar_gib = h0["allreduce_bytes"][0] / 2 ** 30
    plain_ms = [1e3 * t for t in plain["history"]["step_seconds"][1:]]
    log(f"dp_train: two gloo ranks on one card: {pairs_per_s:.2f} global pairs/s, step ms "
        f"mean {np.mean(step_ms):.2f} (plain run, deterministic algorithms, beside the other "
        f"runs: {np.mean(plain_ms):.2f}), gradient all-reduce {ar_gib:.3f} GiB a step in "
        f"{np.mean(ar_ms):.2f} ms mean (host copies and gloo over loopback), peak memory "
        f"{ranks[0]['peak_gib']:.2f} / {ranks[1]['peak_gib']:.2f} GiB (ranks 0 / 1), sweep at "
        f"0.5 {h0['sweep']['0.5']}. Gloo through the host on one card: not a scaling "
        f"figure | {card}")
    for d in ("dp_plain", "dp_nccl1", "dp_gloo", "dp_data"):
        shutil.rmtree(WORK / d, ignore_errors=True)
    return dict(nccl1_equal_plain=same, nondeterministic=nondet,
                launches=dict(plain=plain["launches"], nccl1=nccl["launches"],
                              gloo0=ranks[0]["launches"], gloo1=ranks[1]["launches"]),
                expected=expected, gloo_losses=h0["step_losses"], rank_order_losses=ref,
                plain_losses=plain["history"]["step_losses"], worst_loss_err=max(errs),
                pairs_per_s=pairs_per_s, step_ms=step_ms, plain_step_ms=plain_ms,
                allreduce_ms=ar_ms, allreduce_gib=ar_gib,
                nccl1_allreduce_ms=[1e3 * t for t in nccl["history"]["allreduce_seconds"]],
                peak_gib=[r["peak_gib"] for r in ranks], sweep=h0["sweep"])


def phase_dp_cards(card, n):
    """The finetune of phase 8 (full width, bf16, dropout 0.1, FT_STEPS
    steps and the sweep) on `n` cards. At the global batch 32: one process
    on card 0, then `n` NCCL ranks launched with torchrun's variables, one
    per card (LOCAL_RANK r), 32 / n pairs each; the ranks must end with
    bit-identical parameters and the same sweep, and their global losses
    lie within DP_BF16_TOL of one process on the same global batches
    (_RankOrder, on card 0). Then at 32 pairs a rank (global batch 32 n,
    the reference's per-rank batch) on n * FT_STEPS * 32 pairs: the ranks
    bit for bit alike and every loss finite (one card cannot hold the
    global batch to compare with). Step ms, global pairs/s and the
    gradient all-reduce's ms and bytes of each run, the host sharing its
    cores among the ranks; each run profiles one more step on rank 0
    (device busy ms and share, launch calls, wall ms).
    `python3 chip_smoke.py --dp-cards N` runs it alone, on N cards."""
    from k3m_tpu_torch.config import K3MConfig
    if torch.cuda.device_count() < n:
        raise AssertionError(f"dp_cards: {torch.cuda.device_count()} cards, {n} asked for")
    cfg = K3MConfig.from_json_file(str(BERT))
    (WORK / "finetune_data").mkdir(parents=True, exist_ok=True)
    write_finetune_records(WORK / "finetune_data")
    weak_dir = WORK / "finetune_data_weak"
    weak_dir.mkdir(parents=True, exist_ok=True)
    write_finetune_records(weak_dir, n * FT_STEPS * FT_BATCH)
    spec = dict(mode="finetune", profile=True, card=card)
    one = run_workers([("cards_plain", dict(spec, argv=_finetune_dp_argv(WORK / "dp_cards1")),
                        _dp_env("plain"))], "dp_cards")["cards_plain"]

    def ranks_run(tag, **argv_kw):
        port = _free_port()
        res = run_workers([(f"cards_{tag}{r}",
                            dict(spec, argv=_finetune_dp_argv(WORK / f"dp_cards_{tag}",
                                                              **argv_kw)),
                            _dp_env("torchrun", r, n, port, local_rank=r)) for r in range(n)],
                          "dp_cards")
        ranks = [res[f"cards_{tag}{r}"] for r in range(n)]
        if [r["world"] for r in ranks] != [dict(rank=r, size=n, backend="nccl")
                                           for r in range(n)]:
            raise AssertionError(f"dp_cards: worlds {[r['world'] for r in ranks]}")
        hs = [r["history"] for r in ranks]
        if len({r["params_sha"] for r in ranks}) != 1 or any(
                h["sweep"] != hs[0]["sweep"] or h["step_losses"] != hs[0]["step_losses"]
                for h in hs):
            raise AssertionError(f"dp_cards {tag}: the ranks differ in parameters, sweep "
                                 "or losses")
        if len(hs[0]["step_losses"]) != FT_STEPS or not all(
                math.isfinite(x) for x in hs[0]["step_losses"]):
            raise AssertionError(f"dp_cards {tag}: losses {hs[0]['step_losses']}")
        return ranks

    def summary(runs, ranks_n):
        h = runs[0]["history"]
        timed = h["step_seconds"][1:]
        step_ms = [1e3 * t for t in timed]
        prof = runs[0]["profile"]
        return dict(pairs_per_s=ranks_n * sum(h["step_pairs"][1:]) / sum(timed),
                    step_ms=step_ms, pairs_a_rank=h["step_pairs"][0],
                    allreduce_ms=[1e3 * t for t in h.get("allreduce_seconds", [])[1:]],
                    allreduce_bytes=(h.get("allreduce_bytes") or [0])[0],
                    peak_gib=[r["peak_gib"] for r in runs],
                    launches=[r["launches"] for r in runs],
                    busy_ms=prof["busy_ms"], busy_share=prof["busy_ms"] / np.mean(step_ms),
                    profiled_wall_ms=prof["wall_ms_profiled"],
                    launch_calls=prof["host_launch_calls"],
                    profile_complete=prof["complete"],
                    device_ms_by_class=prof["device_ms_by_class"])

    fixed = ranks_run("nccl")
    ref = rank_order_losses(cfg.replace(use_image=True, with_coattention=True,
                                        if_pre_sampling=1, loss_type="inner",
                                        dtype="bfloat16"), n)
    losses = fixed[0]["history"]["step_losses"]
    errs = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses, ref)]
    if len(ref) != FT_STEPS or max(errs) > DP_BF16_TOL:
        raise AssertionError(f"dp_cards: {n}-rank losses off by {max(errs):.3e}")
    weak = ranks_run("weak", data_dir=weak_dir, batch=n * FT_BATCH)
    res = dict(one_card=summary([one], 1), fixed=summary(fixed, n), weak=summary(weak, n))

    def line(what, r):
        ar = (f", gradient all-reduce {r['allreduce_bytes'] / 2 ** 30:.3f} GiB a step in "
              f"{np.mean(r['allreduce_ms']):.2f} ms mean" if r["allreduce_ms"] else "")
        log(f"dp_cards: {what}: {r['pairs_a_rank']} pairs a rank, {r['pairs_per_s']:.2f} "
            f"global pairs/s, step ms mean {np.mean(r['step_ms']):.2f}{ar}; rank 0's "
            f"profiled step: device busy {r['busy_ms']:.2f} ms (busy share "
            f"{r['busy_share']:.3f} of the mean step), {r['launch_calls']} launch calls, "
            f"wall {r['profiled_wall_ms']:.2f} ms under the profiler; peak memory per rank "
            f"{[round(x, 2) for x in r['peak_gib']]} GiB | {card}")
    line("one process on one card", res["one_card"])
    line(f"{n} NCCL ranks, global batch {FT_BATCH}", res["fixed"])
    line(f"{n} NCCL ranks, global batch {n * FT_BATCH}", res["weak"])
    log(f"dp_cards: {n} ranks at global batch {FT_BATCH}: losses within {max(errs):.3e} of "
        f"one process on the same global batches (tolerance {DP_BF16_TOL:.3e}); ranks bit "
        f"for bit alike in both runs; {FT_BATCH} pairs a rank: "
        f"{res['weak']['pairs_per_s'] / (n * res['one_card']['pairs_per_s']):.3f} of {n} "
        f"times one card's pairs/s | {card} (x{n})")
    for d in ("dp_cards1", "dp_cards_nccl", "dp_cards_weak"):
        shutil.rmtree(WORK / d, ignore_errors=True)
    shutil.rmtree(weak_dir, ignore_errors=True)
    return dict(res, n=n, losses=losses, rank_order_losses=ref, worst_loss_err=max(errs),
                weak_losses=weak[0]["history"]["step_losses"])


def phase_dp_crosscheck(card):
    """One fp32 pretraining train step (k3m_roberta_base at DEPTH_CUT),
    global batch 4 of phase 6's records with a zero-pair item planted at
    global row 2 (rank 1's first), dropout 0.1 and the step's own draws:
    two gloo ranks of 2 rows on the card against one process of 4 rows on
    the card (computed while the ranks run). The four losses within 1e-4
    and every gradient after the
    all-reduce within 1e-3 of the tensor's scale + 1e-7, phase 7's limits,
    but struc_w2.bias, whose gradient is zero in exact arithmetic, held to
    struc_w2.weight's scale as phase 9 holds it (at its own scale two
    roundings of zero are compared: the first run read 0.81 of the limit);
    the two ranks' gradients bit for bit alike."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.random import StepRandom
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    cfg = K3MConfig.from_json_file(str(ROBERTA)).replace(use_image=True, objective=2,
                                                         **DEPTH_CUT)
    batch = next(iter(_pretrain_loader(WORK / "pretrain_data" / "train_feat.k3mr", cfg, 4)))
    for key in ("index_p", "index_v"):
        batch[key][2] = 0
    d = WORK / "dp"
    d.mkdir(parents=True, exist_ok=True)
    torch.save(batch, d / "crosscheck_batch.pt")
    one = {}

    def one_process():                  # while the ranks run
        trainer = PretrainTrainer(cfg, device="cuda", seed=SEED, objective=2)
        loss, metrics = trainer.losses(trainer.stage(batch), deterministic=False,
                                       rng=StepRandom(SEED, 0, "cuda"))
        loss.backward()
        one["losses"] = {k: float(v) for k, v in metrics.items()}
        one["grads"] = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()
                        if p.grad is not None}
        del trainer, loss, metrics
        torch.cuda.empty_cache()
    port = _free_port()
    spec = dict(mode="pretrain_step", batch=str(d / "crosscheck_batch.pt"),
                grads=str(d / "crosscheck_grads.pt"), cfg=DEPTH_CUT)
    res = run_workers([(f"crosscheck_gloo{r}", spec, _dp_env("gloo", r, 2, port))
                       for r in range(2)], "dp_crosscheck", during=one_process)
    want_losses, want = one["losses"], one["grads"]
    r0, r1 = res["crosscheck_gloo0"], res["crosscheck_gloo1"]
    if r0["grads_sha"] != r1["grads_sha"] or r0["losses"] != r1["losses"]:
        raise AssertionError("dp_crosscheck: the two ranks hold different gradients or losses")
    got = torch.load(d / "crosscheck_grads.pt")
    for k in ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv", "loss_struc"):
        err, tol = abs(r0["losses"][k] - want_losses[k]), 1e-4 * max(1.0, abs(want_losses[k]))
        log(f"dp_crosscheck {k}: two ranks {r0['losses'][k]:.6f} one process "
            f"{want_losses[k]:.6f} (tol {tol:.1e})")
        if not (math.isfinite(r0["losses"][k]) and err <= tol):
            raise AssertionError(f"dp_crosscheck {k}: {err} > {tol}")
    worst, worst_name = 0.0, None
    for name, g in got.items():
        a = want.get(name, torch.zeros_like(g))
        scale = want["struc_w2.weight"] if name == ZERO_GRAD_BIAS else a
        tol = 1e-3 * float(scale.abs().max()) + 1e-7
        ratio = max_err(g, a) / tol
        if ratio > worst:
            worst, worst_name = ratio, name
        if not (torch.isfinite(g).all() and ratio <= 1.0):
            raise AssertionError(f"dp_crosscheck gradient {name}: {max_err(g, a)} > {tol}")
    bias = want[ZERO_GRAD_BIAS]
    own = max_err(got[ZERO_GRAD_BIAS], bias) / (1e-3 * float(bias.abs().max()) + 1e-7)
    log(f"dp_crosscheck: {len(want)} gradient tensors of two gloo ranks (after the "
        f"all-reduce, {r0['allreduce_bytes'] / 2 ** 30:.3f} GiB in {1e3 * r0['allreduce_s']:.1f} "
        f"ms) agree with one process on the global batch; worst error/tolerance {worst:.3e} "
        f"({worst_name}); {ZERO_GRAD_BIAS} at its own scale would read {own:.3e} (not held); "
        f"dropout 0.1, the carry of a zero-pair item across the ranks | {card}")
    (d / "crosscheck_grads.pt").unlink()
    return dict(losses_one=want_losses, losses_two=r0["losses"], worst_grad_ratio=worst,
                worst_grad=worst_name, n_grads=len(want), zero_grad_bias_own_scale_ratio=own, allreduce_bytes=r0["allreduce_bytes"],
                allreduce_s=r0["allreduce_s"], peak_gib=[r0["peak_gib"], r1["peak_gib"]],
                launches=dict(gloo0=r0["launches"], gloo1=r1["launches"]))


def phase_dp_predict(card):
    """`finetune --do_pred --bf16` of phase 4 (256 pairs, global batch 64)
    in two gloo ranks: each writes `<jsonl>.part<rank>` from its shard and
    launches the forward kernels of its 4 batches; the parts together hold
    phase 4's pairs, each score within DP_BF16_TOL of phase 4's (bf16
    probabilities in [0, 1], batches of other pairs)."""
    from k3m_tpu_torch.config import K3MConfig
    cfg = K3MConfig.from_json_file(str(BERT))
    argv = ["--data_dir", str(WORK / "data"), "--output_dir", str(WORK / "dp_pred"),
            "--file_test", "test_item_alignment.k3mr", "--use_image", "--with_coattention",
            "--do_pred", "--bf16", "--eval_batch_size", str(BATCH), "--seed", str(SEED),
            "--config_file", "bert_base_6layer_6conect.json", "--log_steps", "1"]
    for k, v in SHAPES.items():
        argv += [f"--{k}", str(v)]
    port = _free_port()
    res = run_workers([(f"predict_gloo{r}", dict(mode="finetune", argv=argv),
                        _dp_env("gloo", r, 2, port)) for r in range(2)], "dp_predict")
    ranks = [res["predict_gloo0"], res["predict_gloo1"]]
    expected = expected_launches(cfg, 2 * math.ceil(N_PAIRS // 2 / (BATCH // 2)))
    read = lambda p: {(x["src_item_id"], x["tgt_item_id"]): x
                      for x in map(json.loads, Path(p).read_text().splitlines())}
    want = read(WORK / "out" / "deepAI_result_threshold=0.5.jsonl")
    got = {}
    for r, res_r in enumerate(ranks):
        if not res_r["output"].endswith(f".part{r}"):
            raise AssertionError(f"dp_predict: rank {r} wrote {res_r['output']}")
        for name, n in expected.items():
            if res_r["launches"][name] != n:
                raise AssertionError(f"dp_predict rank {r}: {name} {res_r['launches'][name]} "
                                     f"launches, expected {n}")
        part = read(res_r["output"])
        if set(part) & set(got):
            raise AssertionError("dp_predict: the parts share a pair")
        got.update(part)
    if set(got) != set(want) or len(want) != N_PAIRS:
        raise AssertionError(f"dp_predict: {len(got)} pairs in the parts, {len(want)} in "
                             "phase 4's dump, or other ids")
    worst = max(abs(float(got[k][s]) - float(x[s])) for k, x in want.items()
                for s in ("src_item_emb", "tgt_item_emb"))
    rates = [sum(r["batch_pairs"][1:]) / sum(r["batch_seconds"][1:]) for r in ranks]
    log(f"dp_predict: the two parts hold phase 4's {len(want)} pairs; worst score difference "
        f"{worst:.3e} (tolerance {DP_BF16_TOL:.3e}); {rates[0]:.2f} / {rates[1]:.2f} pairs/s "
        f"per rank over the batches after the first (ranks sharing the card) | {card}")
    if worst > DP_BF16_TOL:
        raise AssertionError(f"dp_predict: scores differ by {worst}")
    shutil.rmtree(WORK / "dp_pred")
    return dict(worst_score_diff=worst, pairs_per_s=rates, expected=expected,
                launches=dict(gloo0=ranks[0]["launches"], gloo1=ranks[1]["launches"]),
                peak_gib=[r["peak_gib"] for r in ranks])


# ------------------------------------------------------------- legacy path

def _within_scale(got, want):
    """Largest difference over 1e-4 of max(1, want's scale): at most 1 to
    pass."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if want.size == 0:
        return 0.0 if got.size == 0 else math.inf
    return float(np.abs(got - want).max()) / (1e-4 * max(1.0, float(np.abs(want).max())))


def phase_legacy_extract(card):
    """`python -m k3m_tpu_torch.data.legacy_tsv extract --batch_size 4
    --weights` over phase 15's PPM images with phase 15's seeded pkl, on
    the card; then `serialize` against a df CSV. Each TSV row against phase
    15's record of the same image (box count and size equal; boxes,
    features and cls_prob within 1e-4 of their scale); the "b'...'"
    framing; read_tsv against the raw rows decoded by hand, bit for bit; the
    serialized records field for field; no per-image fallback; no port
    kernel. Then phase 15's records through ImageFeaturesReader: the global
    token is the boxes' mean, the locations [x1/w, y1/h, x2/w, y2/h,
    area share] behind [0, 0, 1, 1, 1]."""
    import base64
    import csv

    from k3m_tpu_torch import kernels
    from k3m_tpu_torch.data import legacy_tsv
    from k3m_tpu_torch.data.feature_reader import ImageFeaturesReader
    from k3m_tpu_torch.data.records import RecordReader

    src, d = WORK / "extract", WORK / "legacy_extract"
    d.mkdir(parents=True, exist_ok=True)
    items = [json.loads(line) for line in
             (src / "item_info.jsonl").read_text(encoding="utf-8").splitlines()]
    (d / "image_list.json").write_text(json.dumps(
        [[it["item_id"], it["item_image_name"]] for it in items]))
    tsv = d / "feat.tsv.0"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run = legacy_tsv.main(["extract", "--image_list", str(d / "image_list.json"),
                           "--image_dir", str(src / "images"), "--weights",
                           str(src / "frcnn.pkl"), "--output", str(tsv),
                           "--batch_size", str(EXTRACT_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ex = run["extractor"]
    if ex.fallbacks:
        raise AssertionError(f"legacy_extract: {ex.fallbacks} images through the per-image "
                             "fallback")
    if any(launches.values()):
        raise AssertionError(f"legacy_extract: a port kernel ran: {launches}")
    if run["rows"] != len(items):
        raise AssertionError(f"legacy_extract: {run['rows']} rows for {len(items)} images")
    flushes = ex.flush_seconds
    images_per_s = sum(n for n, _ in flushes[1:]) / sum(t for _, t in flushes[1:])

    # the reference's framing, and read_tsv against the raw rows
    csv.field_size_limit(500 * 1024 * 1024)
    with open(tsv, encoding="utf-8") as f:
        raw = list(csv.DictReader(f, delimiter="\t", fieldnames=legacy_tsv.FIELDNAMES))
    rows = list(legacy_tsv.read_tsv(str(tsv)))
    for r, row in zip(raw, rows):
        n = int(r["num_boxes"])
        for key, width in (("boxes", 4), ("features", 2048), ("cls_prob", 1601)):
            field = r[key]
            if not (field.startswith("b'") and field.endswith("'")):
                raise AssertionError(f"legacy_extract: {key} lacks the b'...' framing")
            arr = np.frombuffer(base64.b64decode(field[2:-1]), np.float32).reshape(n, width)
            if arr.tobytes() != row[key].tobytes():
                raise AssertionError(f"legacy_extract: read_tsv {key} differs from the row")

    # each row against phase 15's record of the same image
    reader = RecordReader(str(src / "train_feat.k3mr"))
    by_id = {str(reader[i]["item_id"]): reader[i] for i in range(len(reader))}
    worst = 0.0
    for row in rows:
        rec = by_id[row["image_id"]]
        for k in ("num_boxes", "image_h", "image_w"):
            if int(rec[k]) != row[k]:
                raise AssertionError(f"legacy_extract: {row['image_id']} {k} {row[k]} against "
                                     f"phase 15's {rec[k]}")
        worst = max([worst] + [_within_scale(row[k], rec[k])
                               for k in ("boxes", "features", "cls_prob")])
    if not worst <= 1.0:
        raise AssertionError(f"legacy_extract: a row differs from phase 15's record "
                             f"({worst} of 1e-4 of the scale)")
    log(f"legacy_extract: {run['rows']} rows in {wall:.2f} s (model load included); "
        f"{images_per_s:.2f} images/s over flushes 2-{len(flushes)} of {EXTRACT_BATCH}; "
        f"b'...' framing; read_tsv equal to the rows; each row against phase 15's "
        f"record: worst {worst:.3e} of 1e-4 of the scale; no fallback, no port kernel "
        f"| {card}")

    # serialize against a df CSV in the reference's columns; one image unmatched
    df = d / "df_train.csv"
    with open(df, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["image_id", "caption", "pv", "category"])
        w.writeheader()
        for it in items[1:]:
            w.writerow(dict(image_id=it["item_id"], caption=it["title"],
                            pv=it["item_pvs"], category=it["cate_name"]))
    out = d / "train_legacy.k3mr"
    ser = legacy_tsv.main(["serialize", "--tsv", str(tsv), "--df_csv", str(df),
                           "--output", str(out)])
    records = list(RecordReader(str(out)))
    if ser["records"] != len(items) - 1 or len(records) != len(items) - 1:
        raise AssertionError(f"legacy_extract: serialize wrote {ser['records']} records")
    for rec, row, it in zip(records, rows[1:], items[1:]):
        want = dict(row, caption=it["title"], pv=it["item_pvs"], category=it["cate_name"])
        if list(rec) != list(want):
            raise AssertionError(f"legacy_extract: record fields {list(rec)}")
        for k, v in want.items():
            same = (rec[k].dtype == v.dtype and rec[k].tobytes() == v.tobytes()
                    if isinstance(v, np.ndarray) else rec[k] == v)
            if not same:
                raise AssertionError(f"legacy_extract: serialized {k} of {row['image_id']}")

    # phase 15's records through ImageFeaturesReader
    feats_reader = ImageFeaturesReader(str(src / "train_feat.k3mr"))
    for item_id, rec in by_id.items():
        feats, n, loc = feats_reader[item_id]
        nb, h, w = int(rec["num_boxes"]), float(rec["image_h"]), float(rec["image_w"])
        boxes = np.asarray(rec["boxes"], np.float32)[:nb]
        mean = (np.asarray(rec["features"], np.float32)[:nb].mean(0) if nb
                else np.zeros(2048, np.float32))
        area = (boxes[:, 3] - boxes[:, 1]) * (boxes[:, 2] - boxes[:, 0]) / (w * h)
        if not (n == nb + 1 and feats.shape == (nb + 1, 2048) and loc.shape == (nb + 1, 5)
                and feats[0].tobytes() == mean.tobytes()
                and (loc[0] == [0, 0, 1, 1, 1]).all()
                and np.allclose(loc[1:, :4], boxes / [w, h, w, h], rtol=1e-6, atol=0)
                and np.allclose(loc[1:, 4], area, rtol=1e-6, atol=0)):
            raise AssertionError(f"legacy_extract: ImageFeaturesReader's {item_id}")
    log(f"legacy_extract: serialize wrote {ser['records']} records (one image without a df "
        f"row dropped) equal field for field to the rows and the df CSV; "
        f"ImageFeaturesReader read {len(by_id)} records of phase 15: global token the "
        f"boxes' mean, the location layout as stated")
    del run, ex, reader, feats_reader
    shutil.rmtree(d)
    shutil.rmtree(src)
    torch.cuda.empty_cache()
    return dict(rows=len(rows), wall_s=wall, images_per_s=images_per_s,
                flush_seconds=flushes, worst_vs_phase15=worst,
                serialized=ser["records"], launches=launches)


LEGACY_SHAPES = dict(max_seq_length=36, max_seq_length_pv=128, max_num_pv=20,
                     max_region_length=36)       # the legacy CLI's defaults
LEGACY_VALID = 16           # validation records of phase 21a: 2 batches of --eval_batch_size 8
LEGACY_CMP_STEPS = 3        # steps of the legacy-vs-pretrain comparison and of phase 21b
LEGACY_ATTN_SHAPES = ((12, 36, 64, "title36"), (12, 128, 64, "pv128"), (8, 37, 128, "image37"))
LEGACY_BIATTN_SHAPES = ((37, 36, 128, "c_layer"), (37, 128, 128, "c_layer_pv_v"),
                        (128, 36, 96, "c_layer_pv_t"))


def expected_eval_launches(cfg, forwards, head_lns=3):
    """Kernel launches of `forwards` pretraining forwards without a
    backward (eval_step)."""
    return dict(expected_train_launches(cfg, forwards, head_lns), layernorm_bwd=0,
                attention_bwd=0)


def _plus(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in a.keys() | b.keys()}


def _legacy_argv(data_dir, out_dir, *extra, file_name="train_feat.k3mr"):
    """`k3m_tpu_torch.train_concap_struc` at batch 96 in bf16, the default
    config (bert_base_6layer_6conect.json), random weights from SEED."""
    return ["--data_dir", str(data_dir), "--output_dir", str(out_dir), "--file_name",
            file_name, "--train_batch_size", str(TRAIN_BATCH), "--bf16", "--seed", str(SEED),
            "--num_train_epochs", "1", "--log_steps", "1", *extra]


def _readme_shapes():
    """The README command's shapes: title 50, pv 256, 30 pvs (36 RoIs, the
    CLI's default)."""
    return [f"--{k}={v}" for k, v in SHAPES.items() if k != "max_region_length"]


def _legacy_run(argv, expected, what):
    """One run of the legacy CLI from counts at 0: every kernel counter
    equal to `expected`, every step's losses finite, the epoch checkpoint
    and hyperparamter.txt written; the checkpoint then deleted."""
    from k3m_tpu_torch import kernels, train_concap_struc as legacy
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = legacy.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{what}: launches {counts} expected {expected}")
    for name, want in expected.items():
        if counts[name] != want or counts[name] == 0:
            raise AssertionError(f"{what}: {name}: {counts[name]} launches, expected {want}")
    (hist,) = run["history"]
    for i, losses in enumerate(hist["step_losses"]):
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{what} step {i}: non-finite losses {losses}")
    out_dir = Path(argv[argv.index("--output_dir") + 1])
    args_part, config_part = (out_dir / "hyperparamter.txt").read_text().split("\n\n")
    if not (json.loads(args_part)["train_batch_size"] == TRAIN_BATCH
            and json.loads(config_part)["with_coattention"]):
        raise AssertionError(f"{what}: hyperparamter.txt does not hold the args and config")
    ckpt = Path(hist["checkpoint_path"])
    if not ((ckpt / "state.pt").exists() and (ckpt / "pytorch_model.bin").exists()):
        raise AssertionError(f"{what}: no epoch checkpoint in {ckpt}")
    shutil.rmtree(ckpt)
    return run, hist, counts, peak


def legacy_kernel_rows(card):
    """Each kernel against its plain version at the legacy CLI's default
    shapes (title 36, pv 128, 20 pvs, 36 RoIs + 1) at batch 96, as phase 3
    holds them: #3/#4/#5 in bf16 at rate 0.1 and in fp32 at rate 0, forward
    and backward (planted faults rejected at rate 0.1); #1/#2 on the rows of
    each stream, fp32 and bf16, with and without a residual; timed with
    bound and library call (SDPA and its backward; two SDPA calls for #5)."""
    f32, bf16 = torch.float32, torch.bfloat16
    B = TRAIN_BATCH
    ln = ((B * 36, 768, "title36"), (B * 128, 768, "pv128"), (B * 37, 1024, "image37"))
    rows = []
    kernel_phase_layernorm(card, rows, cases=[(B, shape, ((f32, f32), (bf16, bf16)))
                                              for shape in ln])
    kernel_phase_layernorm_bwd(card, rows, cases=[(B, shape, (f32, bf16)) for shape in ln])
    cases = [(B, f32, 0.0), (B, bf16, 0.1)]
    kernel_phase_attention(card, rows, cases=cases, shapes=LEGACY_ATTN_SHAPES)
    kernel_phase_biattention(card, rows, cases=cases, shapes=LEGACY_BIATTN_SHAPES)
    kernel_phase_attention_bwd(card, rows, runs=((B, (f32,), (0.0,)), (B, (bf16,), (0.1,))),
                               attn_shapes=LEGACY_ATTN_SHAPES, bi_shapes=LEGACY_BIATTN_SHAPES)
    torch.cuda.empty_cache()
    return rows


def phase_legacy_train(card):
    """(a) The README's quick-start command through the port's legacy CLI at
    full width: `python -m k3m_tpu_torch.train_concap_struc --do_train
    --do_eval --train_batch_size 96 --max_seq_length 50 --max_seq_length_pv
    256 --max_num_pv 30 --bf16` on phase 6's 864 records (36 boxes each) and
    a valid sibling of LEGACY_VALID, the default config, random weights
    from SEED: launch counts of 9 steps and 2 eval forwards, losses finite,
    hyperparamter.txt and the epoch checkpoint; samples/s, step ms, peak
    memory, device busy ms of one more profiled step. Then the first 3
    steps of this CLI and of `k3m_tpu_torch.pretrain` with the matching
    flags on the same records (the config at DEPTH_CUT), under
    torch.use_deterministic_algorithms: losses and parameters bit for bit.
    (b) The CLI's default shapes (36/128/20) at batch 96 for 3 steps at
    DEPTH_CUT: launch counts, then every kernel
    held at these shapes (legacy_kernel_rows). (c) A raw TSV of 96 rows
    with a valid sibling: converted by find_records, one step (the config
    at DEPTH_CUT); a second run reuses the conversion."""
    from k3m_tpu_torch import kernels, pretrain
    from k3m_tpu_torch.config import K3MConfig
    cfg = K3MConfig.from_json_file(str(BERT))
    res = {}

    # (a) the README command
    data = WORK / "legacy_data"
    data.mkdir(parents=True, exist_ok=True)
    os.symlink(WORK / "pretrain_data" / "train_feat.k3mr", data / "train_feat.k3mr")
    write_pretrain_records(data / "valid_feat.k3mr", LEGACY_VALID, seed=SEED + 3)
    expected = _plus(expected_train_launches(cfg, TRAIN_STEPS),
                     expected_eval_launches(cfg, LEGACY_VALID // 8))
    run, hist, counts, peak = _legacy_run(
        _legacy_argv(data, WORK / "legacy_out", "--do_train", "--do_eval", *_readme_shapes()),
        expected, "legacy_train (a)")
    if len(hist["step_seconds"]) != TRAIN_STEPS or not math.isfinite(hist["val_loss"]):
        raise AssertionError(f"legacy_train (a): {len(hist['step_seconds'])} steps, "
                             f"val_loss {hist['val_loss']}")
    timed = hist["step_seconds"][1:]
    samples_per_s = sum(hist["step_samples"][1:]) / sum(timed)
    step_ms = [1e3 * t for t in timed]
    log(f"legacy_train (a): the README command, {TRAIN_STEPS} steps of {TRAIN_BATCH} at "
        f"50/256/30/36 (bert_base_6layer_6conect, bf16): {samples_per_s:.2f} samples/s over "
        f"steps 2-{TRAIN_STEPS}, step ms mean {sum(step_ms) / len(step_ms):.2f} min "
        f"{min(step_ms):.2f} max {max(step_ms):.2f} (first "
        f"{1e3 * hist['step_seconds'][0]:.2f}); val_loss {hist['val_loss']:.4f}; peak memory "
        f"{peak:.2f} GiB | {card}")
    trainer = run["trainer"]
    batch = trainer.stage(next(iter(_pretrain_loader(data / "train_feat.k3mr", cfg,
                                                     TRAIN_BATCH))))
    prof = profile_device(lambda: trainer.train_step(batch), card,
                          f"bf16 legacy train step of {TRAIN_BATCH}", n=1)
    log_busy_share("legacy_train (a)", prof["busy_ms"], step_ms, card)
    res["readme"] = dict(launches=counts, expected=expected, samples_per_s=samples_per_s,
                         step_ms=step_ms, first_step_ms=1e3 * hist["step_seconds"][0],
                         peak_gib=peak, val_loss=hist["val_loss"],
                         step_losses=hist["step_losses"], profile=prof)
    del run, trainer, batch
    torch.cuda.empty_cache()

    # the first 3 steps of the legacy CLI and of the pretraining CLI
    cmp_data = WORK / "legacy_cmp_data"
    cut = write_cut_config(BERT, cmp_data)
    write_pretrain_records(cmp_data / "train_feat.k3mr", LEGACY_CMP_STEPS * TRAIN_BATCH,
                           seed=SEED + 4)
    plain_argv = ["--data_dir", str(cmp_data), "--output_dir", str(WORK / "legacy_cmp_p"),
                  "--file_name", "{}_feat.k3mr", "--config_file", BERT.name, "--use_image",
                  "--model_name", "bert-base-chinese", "--num_negative_image", "255",
                  "--num_negative_pv", str(cfg.num_negative_pv), "--margin", str(cfg.margin),
                  "--train_batch_size", str(TRAIN_BATCH), "--bf16", "--seed", str(SEED),
                  "--num_train_epochs", "1", "--log_steps", "1", *_readme_shapes()]
    torch.use_deterministic_algorithms(True)
    try:
        a, ha, _, _ = _legacy_run(_legacy_argv(cmp_data, WORK / "legacy_cmp_l", "--do_train",
                                               *_readme_shapes()),
                                  expected_train_launches(cut, LEGACY_CMP_STEPS),
                                  "legacy_train (a) legacy CLI, 3 steps")
        params_a = {k: v.detach().clone() for k, v in a["trainer"].model.state_dict().items()}
        config_a = a["trainer"].config.to_dict()
        del a
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        b = pretrain.main(plain_argv)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    (hb,) = b["history"]
    shutil.rmtree(hb["checkpoint_path"])
    unequal = [k for k, v in b["trainer"].model.state_dict().items()
               if not torch.equal(v, params_a[k])]
    if (ha["step_losses"] != hb["step_losses"] or unequal
            or b["trainer"].config.to_dict() != config_a):
        raise AssertionError(f"legacy_train (a): the legacy CLI's first {LEGACY_CMP_STEPS} "
                             f"steps differ from k3m_tpu_torch.pretrain's: losses "
                             f"{ha['step_losses']} against {hb['step_losses']}; "
                             f"{len(unequal)} parameters differ")
    log(f"legacy_train (a): the first {LEGACY_CMP_STEPS} steps of the legacy CLI and of "
        f"k3m_tpu_torch.pretrain (same records, config, flags and seed, deterministic "
        f"algorithms): losses and all {len(params_a)} parameters bit for bit equal")
    res["against_pretrain"] = dict(steps=LEGACY_CMP_STEPS, losses=ha["step_losses"],
                                   parameters=len(params_a))
    del b, params_a
    torch.cuda.empty_cache()

    # (b) the CLI's default shapes
    run, hist, counts, peak = _legacy_run(
        _legacy_argv(cmp_data, WORK / "legacy_defaults", "--do_train"),
        expected_train_launches(cut, LEGACY_CMP_STEPS), "legacy_train (b)")
    timed = hist["step_seconds"][1:]
    res["defaults"] = dict(launches=counts, step_losses=hist["step_losses"], peak_gib=peak,
                           samples_per_s=sum(hist["step_samples"][1:]) / sum(timed),
                           step_ms=[1e3 * t for t in timed])
    log(f"legacy_train (b): {LEGACY_CMP_STEPS} steps of {TRAIN_BATCH} at the CLI's defaults "
        f"36/128/20/36: {res['defaults']['samples_per_s']:.2f} samples/s over steps 2-"
        f"{LEGACY_CMP_STEPS}, peak memory {peak:.2f} GiB | {card}")
    del run
    torch.cuda.empty_cache()
    res["kernel_rows"] = legacy_kernel_rows(card)

    # (c) a raw TSV with a valid sibling, converted once
    from k3m_tpu_torch.tokenization import build_synthetic_vocab
    raw = WORK / "legacy_raw"
    write_cut_config(BERT, raw)
    rng, vocab = np.random.default_rng(SEED + 5), build_synthetic_vocab()
    for name, n in (("train_raw.tsv", TRAIN_BATCH), ("valid_raw.tsv", 8)):
        with open(raw / name, "w", encoding="utf-8") as f:
            for i in range(n):
                it = _synthetic_item(rng, vocab, i, n_boxes=0)
                f.write(f"{name[:5]}{i}\t{it['title']}\thttp://img.example/{i}.jpg\t"
                        f"{it['pv'].replace(':', '#:#')}\t{it['category']}\n")
    expected = _plus(expected_train_launches(cut, 1), expected_eval_launches(cut, 1))
    stamps = []
    for k in range(2):
        run, hist, counts, _ = _legacy_run(
            _legacy_argv(raw, WORK / f"legacy_raw_out{k}", "--do_train", "--do_eval",
                         file_name="train_raw.tsv"),
            expected, f"legacy_train (c) run {k + 1}")
        if len(hist["step_seconds"]) != 1 or not math.isfinite(hist["val_loss"]):
            raise AssertionError(f"legacy_train (c): {len(hist['step_seconds'])} steps")
        stamps.append([os.stat(raw / f"{n}.k3mr").st_mtime_ns
                       for n in ("train_raw.tsv", "valid_raw.tsv")])
        del run
        torch.cuda.empty_cache()
    if stamps[0] != stamps[1]:
        raise AssertionError("legacy_train (c): the second run converted the TSV again")
    log(f"legacy_train (c): a raw TSV of {TRAIN_BATCH} rows and its valid sibling converted "
        f"once by find_records, one step and the validation on each of two runs, losses "
        f"finite, the conversion reused")
    res["raw"] = dict(launches=counts, expected=expected)
    res["per_step"] = expected_train_launches(cfg, 1)
    for d in ("legacy_data", "legacy_cmp_data", "legacy_raw", "legacy_out", "legacy_cmp_l",
              "legacy_cmp_p", "legacy_defaults", "legacy_raw_out0", "legacy_raw_out1"):
        shutil.rmtree(WORK / d, ignore_errors=True)
    return res


# ------------------------------------------------------------------ main

# ------------------------------------------------------ tensor parallelism

TP_MS = (2, 4)              # model ranks of the TP kernel rows (phase 3)
TP_STEPS = 2                # steps of each CLI run of phase 23, the first a warm-up
TP_PRETRAIN_BATCH = 16      # phase 23's global batches: gloo's host path, not a speed figure
TP_FT_BATCH = 8             # pairs; 32 took 25-33 s a step and the script past 1000 s
TP_EVAL_PAIRS = 16          # phase 23's sweep and predict batch: phase 4's first 16 pairs
TP_CARDS_STEPS = 4          # steps of each --tp-cards run, the first a warm-up


def tp_shapes(M):
    """The attention and bi-attention shapes of model rank M - 1 of M: each
    layer's heads split M ways (text 12, image 8, co-attention 8), the
    rank's heads the last of them."""
    attn = tuple((H // M, L, D, f"{what} tp{M}", (M - 1) * (H // M), H)
                 for H, L, D, what in ATTN_SHAPES)
    bi = tuple((L1, L2, D, f"{what} tp{M}", (M - 1) * (8 // M), 8)
               for L1, L2, D, what in BIATTN_SHAPES)
    return attn, bi


def tp_kernel_rows(card):
    """#3/#4/#5 at the head counts of M = 2 and 4 model ranks (text 12/M
    heads of 64 at L50/256, image 8/M of 128 at L37, the co-attention
    layers 8/M at D128 and D96) at batch 96, as a model rank calls them:
    bf16 at rate 0.1 and fp32 at rate 0, forward and backward, each held to
    its plain version under phase 3's tolerances (planted faults rejected
    at rate 0.1), the forwards' mask words bit for bit to the rank's head
    slice of the whole layer's mask; timed beside bound and SDPA. #1/#2 see
    the replicated rows of phase 3 under tensor parallelism."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, rows = TRAIN_BATCH, []
    cases = [(B, f32, 0.0), (B, bf16, 0.1)]
    for M in TP_MS:
        attn, bi = tp_shapes(M)
        kernel_phase_attention(card, rows, cases=cases, shapes=attn)
        kernel_phase_biattention(card, rows, cases=cases, shapes=bi, heads=8 // M)
        kernel_phase_attention_bwd(card, rows, runs=((B, (f32,), (0.0,)),
                                                     (B, (bf16,), (0.1,))),
                                   attn_shapes=attn, bi_shapes=bi, bi_heads=8 // M)
        torch.cuda.empty_cache()
    return rows


def _full_grads(model, world):
    """Every gradient of `model`, the split ones gathered over the model
    group (none are where no gradient reached them), fp32 on the host."""
    from k3m_tpu_torch.train import mesh
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        dim = mesh.shard_dim(name)
        g = p.grad if world.n_model == 1 or dim is None else \
            mesh.gather_tensor(p.grad, dim, world)
        out[name] = g.float().cpu()
    return out


def _batch_rows(tree, i, n):
    """Rows i * n .. (i + 1) * n of every array and list of a host batch."""
    if isinstance(tree, dict):
        return {k: _batch_rows(v, i, n) for k, v in tree.items()}
    return tree[i * n:(i + 1) * n]


def _tp_finetune_step(spec):
    """One fp32 finetune train step (bert_base_6layer_6conect, loss inner,
    dropout 0.1 and the step's own draws) on this data group's pairs of the
    spec's global batch: the global loss, and the gradients after the
    data-group all-reduce, gathered (rank 0 saves them)."""
    from k3m_tpu_torch.model.random import StepRandom
    from k3m_tpu_torch.train import dist
    from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer, decode_items
    from k3m_tpu_torch.train.dist import all_reduce_grads
    world = dist.init_from_env("cuda", spec.get("n_model", 1))
    try:
        batch = torch.load(spec["batch"], weights_only=False)
        local = _batch_rows(batch, world.data_rank, len(batch["label"]) // world.data_size)
        trainer = AlignmentTrainer(_tp_finetune_cfg(), device=world.device, seed=SEED,
                                   world=world)
        b = decode_items(trainer.stage(local), trainer.config)
        loss = trainer.model(b["label"], b["item1"], b["item2"], deterministic=False,
                             rng=StepRandom(SEED, 0, world.device), world=world)[3]
        loss.backward()
        all_reduce_grads(world, trainer.model.parameters())
        loss = trainer.global_metrics(dict(loss=loss.detach()))["loss"]
        grads = _full_grads(trainer.model, world)
        if world.rank == 0:
            torch.save(grads, spec["grads"])
        return dict(world=dict(rank=world.rank, size=world.size, n_model=world.n_model),
                    losses=dict(loss=float(loss)), grads_sha=_sha(grads.items()))
    finally:
        world.close()


def _tp_finetune_cfg():
    """Phase 22's finetune: bert_base_6layer_6conect at DEPTH_CUT, loss
    inner, dropout at the config's 0.1."""
    from k3m_tpu_torch.config import K3MConfig
    return K3MConfig.from_json_file(str(BERT)).replace(
        use_image=True, with_coattention=True, loss_type="inner", if_pre_sampling=1,
        **DEPTH_CUT)


def _tp_cli(spec):
    """`python -m k3m_tpu_torch.<spec's cli>` with the spec's argv, in the
    world its environment gives, the world held past the CLI's end: the
    history, the predict file, the model's parameters gathered (their
    sha), the collectives of each train step by axis ([count, bytes, host
    seconds]: each step's counts taken from the world's before and after
    it), and under `profile` one more train step on this rank's rows of a
    batch of the spec's records (rank 0 under the profiler: device ms,
    NCCL kernels' ms apart)."""
    import importlib
    from k3m_tpu_torch.dist import World
    from k3m_tpu_torch.train import dist, mesh
    from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    held, init, step_traffic = [], dist.init_from_env, []

    def init_and_hold(device, n_model=1):
        world = init(device, n_model)
        world.close = lambda: None
        held.append(world)
        return world

    def counting(step):
        def train_step(self, batch):
            before = {k: list(v) for k, v in self.world.traffic.items()}
            out = step(self, batch)
            step_traffic.append({k: [v[i] - before.get(k, (0, 0, 0.0))[i] for i in range(3)]
                                 for k, v in self.world.traffic.items()})
            return out
        return train_step
    steps = {cls: cls.train_step for cls in (PretrainTrainer, AlignmentTrainer)}
    for cls, step in steps.items():
        cls.train_step = counting(step)
    dist.init_from_env = init_and_hold
    try:
        run = importlib.import_module(f"k3m_tpu_torch.{spec['cli']}").main(spec["argv"])
    finally:
        dist.init_from_env = init
        for cls, step in steps.items():
            cls.train_step = step
    (world,) = held
    try:
        out = dict(world=dict(rank=world.rank, size=world.size, n_model=world.n_model,
                              backend=world.backend), step_traffic=step_traffic)
        if run.get("history"):
            (h,) = run["history"]
            out["history"] = {k: h[k] for k in ("step_seconds", "step_samples", "step_pairs",
                                                "step_losses", "sweep", "checkpoint_path")
                              if k in h}
        if "output" in run:
            out.update(output=run["output"], batch_seconds=run["batch_seconds"],
                       batch_pairs=run["batch_pairs"])
        trainer = run.get("trainer")
        if trainer is not None:
            out["params_sha"] = _sha(mesh.full_state_dict(trainer.model, world).items())
        if spec.get("profile"):
            path, batch = spec["profile"]
            staged = trainer.stage(next(iter(_pretrain_loader(
                Path(path), trainer.config, world.local_rows(batch, "batch")))))
            step = lambda: trainer.train_step(staged)
            out["profile"] = None
            if world.rank == 0:
                prof = profile_device(step, spec.get("card", ""), f"rank 0 of {world.size} "
                                      f"(n_model {world.n_model}): pretraining train step",
                                      n=1)
                prof["nccl_ms"] = sum(ms for ms, _, name in prof["top_other"]
                                      if "nccl" in name.lower())
                out["profile"] = prof
            else:
                step()
                torch.cuda.synchronize()
    finally:
        World.close(world)
    return out


def _check_tp_grads(what, want_losses, want, r0, r1, got, zero_grad_scale, card):
    """Two model ranks' step against one process: both ranks report the
    same losses and gradients, the losses within 1e-4 of max(1, |loss|),
    every gradient (gathered) within 1e-3 of its tensor's scale + 1e-7
    (phase 7's and 9's limits; ZERO_GRAD_BIAS, zero in exact arithmetic, at
    struc_w2.weight's scale, as phases 9 and 18 hold it). Returns the
    worst error/tolerance and its tensor."""
    if r0["grads_sha"] != r1["grads_sha"] or r0["losses"] != r1["losses"]:
        raise AssertionError(f"{what}: the model ranks hold different gradients or "
                             "losses")
    for k, w in want_losses.items():
        err, tol = abs(r0["losses"][k] - w), 1e-4 * max(1.0, abs(w))
        log(f"{what} {k}: the model ranks {r0['losses'][k]:.6f} one process {w:.6f} "
            f"(tol {tol:.1e})")
        if not (math.isfinite(r0["losses"][k]) and err <= tol):
            raise AssertionError(f"{what} {k}: {err} > {tol}")
    if not set(want) <= set(got):
        raise AssertionError(f"{what}: gradients missing: {sorted(set(want) - set(got))[:4]}")
    worst, worst_name = 0.0, None
    for name, g in got.items():
        a = want.get(name, torch.zeros_like(g))
        scale = want["struc_w2.weight"] if name == ZERO_GRAD_BIAS and zero_grad_scale else a
        tol = 1e-3 * float(scale.abs().max()) + 1e-7
        ratio = max_err(g, a) / tol
        if ratio > worst:
            worst, worst_name = ratio, name
        if not (torch.isfinite(g).all() and ratio <= 1.0):
            raise AssertionError(f"{what} gradient {name}: {max_err(g, a)} > {tol}")
    log(f"{what}: {len(got)} gradient tensors of the model ranks (gathered) agree with one "
        f"process; worst error/tolerance {worst:.3e} ({worst_name}) | {card}")
    return worst, worst_name


# phase 22's --n_model 8 step: k3m_roberta_base's widths and heads, cut to
# 2 text layers, 1 image layer and one co-attention block of each kind
TP8_CUT = dict(num_hidden_layers=2, v_num_hidden_layers=1, v_biattention_id=[0],
               t_biattention_id=[1])


def _check_tp_masks(one, prefix, M, card):
    """Each model rank's mask words, call by call, against one process's:
    a layer whose heads M divides drew its rank's head slice, one whose
    heads it does not (the 12 text heads at 8) drew all of them, bit for
    bit. Returns (calls, replicated calls) per rank."""
    out = []
    for r in range(M):
        calls = torch.load(f"{prefix}.{r}")
        Path(f"{prefix}.{r}").unlink()
        if len(calls) != len(one) or not calls:
            raise AssertionError(f"tp masks rank {r}: {len(calls)} calls, one process "
                                 f"{len(one)}")
        full = 0
        for i, ((h0, words), (_, whole)) in enumerate(zip(calls, one)):
            H = words.shape[1]
            full += H == whole.shape[1]
            if not torch.equal(words, whole[:, h0:h0 + H]):
                raise AssertionError(f"tp masks rank {r} call {i}: heads {h0}..{h0 + H - 1} "
                                     "differ from one process's")
        out.append((len(calls), full))
    if not all(f and f < n for n, f in out):
        raise AssertionError(f"tp masks: calls and replicated calls per rank {out}")
    log(f"tp_crosscheck --n_model {M}: every rank's mask words equal one process's "
        f"(calls, of them all heads) {out[0]} | {card}")
    return out


def phase_tp_crosscheck(card, during=None):
    """Two gloo ranks with --n_model 2 sharing the card against one process
    on the card (computed while the ranks run), fp32, dropout 0.1 with the
    step's own draws (the Philox masks keyed by global head): one
    pretraining train step (k3m_roberta_base at DEPTH_CUT) on phase 18's
    global batch of 4 and its zero-pair item, the four losses and every
    gathered gradient to phase 7's limits; one finetune train step
    (bert_base_6layer_6conect at DEPTH_CUT, loss inner) at batch 2 of
    phase 8's pairs,
    the loss and every gradient to phase 9's; eight gloo ranks with
    --n_model 8 at the TP8_CUT depth, the pretraining step against one
    process at the same cut, and every mask word against one process's
    (_check_tp_masks). The three worlds run at once; this process computes
    the references while they run, then `during()` (phase 24)."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.random import StepRandom
    from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer, decode_items
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    d = WORK / "dp"
    d.mkdir(parents=True, exist_ok=True)
    cfg = K3MConfig.from_json_file(str(ROBERTA)).replace(use_image=True, objective=2)
    batch = next(iter(_pretrain_loader(WORK / "pretrain_data" / "train_feat.k3mr", cfg, 4)))
    for key in ("index_p", "index_v"):
        batch[key][2] = 0
    torch.save(batch, d / "tp_batch.pt")
    fcfg = _tp_finetune_cfg()
    pairs = _load_batch(WORK / "finetune_data" / "train_item_alignment.k3mr", fcfg, 2)
    torch.save(pairs, d / "tp_pairs.pt")
    one = {}

    def grads_of(model):
        return {n: p.grad.float().cpu() for n, p in model.named_parameters()
                if p.grad is not None}

    def one_process():                  # while the ranks run
        for what, c in (("pretrain", cfg.replace(**DEPTH_CUT)),
                        ("pretrain_m8", cfg.replace(**TP8_CUT))):
            trainer = PretrainTrainer(c, device="cuda", seed=SEED, objective=2)
            with recording_masks() as masks:
                loss, metrics = trainer.losses(trainer.stage(batch), deterministic=False,
                                               rng=StepRandom(SEED, 0, "cuda"))
            loss.backward()
            one[what] = ({k: float(metrics[k]) for k in (
                "masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv", "loss_struc")},
                grads_of(trainer.model), masks)
            del trainer, loss, metrics
        trainer = AlignmentTrainer(fcfg, device="cuda", seed=SEED)
        b = decode_items(trainer.stage(pairs), fcfg)
        loss = trainer.model(b["label"], b["item1"], b["item2"], deterministic=False,
                             rng=StepRandom(SEED, 0, "cuda"))[3]
        loss.backward()
        one["finetune"] = (dict(loss=loss.item()), grads_of(trainer.model))
        del trainer, loss
        torch.cuda.empty_cache()
    jobs = []
    for what, mode, data, M, extra in (
            ("pretrain", "pretrain_step", "tp_batch.pt", 2, dict(cfg=DEPTH_CUT)),
            ("finetune", "finetune_step", "tp_pairs.pt", 2, {}),
            ("pretrain_m8", "pretrain_step", "tp_batch.pt", 8,
             dict(cfg=TP8_CUT, masks=str(d / "tp_masks_m8")))):
        port = _free_port()
        spec = dict(mode=mode, n_model=M, batch=str(d / data),
                    grads=str(d / f"tp_grads_{what}.pt"), **extra)
        jobs += [(f"tp_cross_{what}{r}", spec, _dp_env("gloo", r, M, port)) for r in range(M)]
    def this_process():                 # the references, then `during`
        one_process()
        if during is not None:
            during()
    res = run_workers(jobs, "tp_crosscheck", during=this_process)
    out = {}
    for what, M in (("pretrain", 2), ("finetune", 2), ("pretrain_m8", 8)):
        ranks = [res[f"tp_cross_{what}{r}"] for r in range(M)]
        r0 = ranks[0]
        want_losses, want = one[what][:2]
        for r in ranks[2:]:
            if r["grads_sha"] != r0["grads_sha"] or r["losses"] != r0["losses"]:
                raise AssertionError(f"tp_crosscheck {what}: the model ranks hold different "
                                     "gradients or losses")
        worst = _check_tp_grads(f"tp_crosscheck {what}", want_losses, want, r0, ranks[1],
                                torch.load(d / f"tp_grads_{what}.pt"), True, card)
        out[what] = dict(losses_one=want_losses, losses_ranks=r0["losses"],
                         worst_grad_ratio=worst[0], worst_grad=worst[1],
                         peak_gib=[r["peak_gib"] for r in ranks],
                         launches={f"gloo{i}": r["launches"] for i, r in enumerate(ranks)},
                         traffic=r0.get("traffic"))
        (d / f"tp_grads_{what}.pt").unlink()
    out["pretrain_m8"]["masks"] = _check_tp_masks(one["pretrain_m8"][2],
                                                  d / "tp_masks_m8", 8, card)
    for f in ("tp_batch.pt", "tp_pairs.pt"):
        (d / f).unlink()
    return out


def _one_process_sha(build, path):
    """sha of the state of a one-process model (`build()` on the meta
    device, then on the card) that loads the model file `path`
    (convert.load_model_file), and its tensors' shapes."""
    from k3m_tpu_torch.convert import load_model_file
    with torch.device("meta"):
        model = build()
    model = model.to_empty(device="cuda")
    load_model_file(model, str(path))
    sd = model.state_dict()
    out = _sha(sd.items()), {k: tuple(v.shape) for k, v in sd.items()}
    del model, sd
    torch.cuda.empty_cache()
    return out


def phase_tp_train(card):
    """The three training CLIs with --n_model 2, each as two gloo ranks
    sharing the card (the K3M_* variables, K3M_DIST_BACKEND=gloo), the
    three pairs at once, bf16, the shipped widths at DEPTH_CUT, TP_STEPS
    steps each, at small global batches (gloo's host path: no speed
    figure):
    `k3m_tpu_torch.pretrain` (k3m_roberta_base, batch 16), `finetune
    --do_train --do_eval --do_pred` (bert_base_6layer_6conect with phase
    4's flags, 8 pairs, the sweep and predict at batch TP_EVAL_PAIRS, over
    as many validation pairs and phase 4's first pairs, learning rate 0 so
    that the weights stay phase 4's seeded ones),
    `train_concap_struc` (its default shapes, batch 16). Both model ranks
    must report the same losses (and sweep) and gathered parameters, each
    launch every kernel the count the config gives; rank 0 alone writes the
    checkpoint, whose `pytorch_model.bin` has full shapes and loads into a
    one-process model with those parameters bit for bit; model rank 0's
    predict file (one data group: no part suffix) holds those pairs with
    the scores of one process's predict (run while the ranks run) within
    2^-6. Step ms, the model-group all-reduces'
    count, bytes and host ms a step, peak memory per rank."""
    import importlib
    from k3m_tpu_torch.model.alignment import K3MForItemAlignment
    from k3m_tpu_torch.model.pretrain import K3MForPretraining
    data, ft_data = WORK / "tp_data", WORK / "tp_ft_data"
    roberta, bert = write_cut_config(ROBERTA, data), write_cut_config(BERT, data)
    write_cut_config(BERT, ft_data)
    write_pretrain_records(data / "train_feat.k3mr", TP_STEPS * TP_PRETRAIN_BATCH)
    write_finetune_records(ft_data, TP_STEPS * TP_FT_BATCH, TP_EVAL_PAIRS)
    write_pair_records(ft_data / "test_item_alignment.k3mr", TP_EVAL_PAIRS)
    tp = ("--n_model", "2")
    ft_argv = ["--data_dir", str(ft_data), "--output_dir", str(WORK / "tp_finetune"),
               "--config_file", str(ft_data / BERT.name), "--use_image",
               "--with_coattention", "--do_train", "--do_eval", "--do_pred", "--bf16",
               "--train_batch_size", str(TP_FT_BATCH), "--eval_batch_size",
               str(TP_EVAL_PAIRS),
               "--learning_rate", "0", "--num_train_epochs", "1", "--seed", str(SEED),
               "--log_steps", "1", *tp]
    for k, v in SHAPES.items():
        ft_argv += [f"--{k}", str(v)]
    runs = dict(
        pretrain=(_pretrain_argv(data, WORK / "tp_pretrain", *tp, "--train_batch_size",
                                 str(TP_PRETRAIN_BATCH)),
                  expected_train_launches(roberta, TP_STEPS), K3MForPretraining),
        finetune=(ft_argv,
                  _plus(expected_finetune_launches(bert, TP_STEPS, 1), expected_launches(bert, 2)),
                  K3MForItemAlignment),
        train_concap_struc=(_legacy_argv(data, WORK / "tp_legacy", "--do_train", *tp,
                                         "--train_batch_size", str(TP_PRETRAIN_BATCH)),
                            expected_train_launches(bert, TP_STEPS), K3MForPretraining))
    jobs = []
    for cli, (argv, _, _) in runs.items():
        port = _free_port()
        jobs += [(f"tp_{cli}{r}", dict(mode="cli", cli=cli, argv=argv),
                  _dp_env("gloo", r, 2, port)) for r in range(2)]
    one = {}

    def one_process_predict():          # the reference, while the ranks run
        from k3m_tpu_torch import finetune
        argv = [a for a in ft_argv if a not in ("--do_train", "--do_eval")]
        del argv[argv.index("--n_model"):argv.index("--n_model") + 2]
        argv[argv.index("--output_dir") + 1] = str(WORK / "tp_predict_one")
        one["output"] = finetune.main(argv)["output"]
        torch.cuda.empty_cache()
    got = run_workers(jobs, "tp_train", during=one_process_predict)
    res = {}
    for cli, (argv, expected, model_class) in runs.items():
        ranks = [got[f"tp_{cli}{r}"] for r in range(2)]
        what = f"tp_train {cli}"
        if [r["world"] for r in ranks] != [dict(rank=r, size=2, n_model=2, backend="gloo")
                                           for r in range(2)]:
            raise AssertionError(f"{what}: worlds {[r['world'] for r in ranks]}")
        for r, rank in enumerate(ranks):
            if any(rank["launches"][k] != n or n == 0 for k, n in expected.items()):
                raise AssertionError(f"{what} rank {r}: launches {rank['launches']}, "
                                     f"expected {expected}")
        h0, h1 = ranks[0]["history"], ranks[1]["history"]
        if h0["step_losses"] != h1["step_losses"] or h0.get("sweep") != h1.get("sweep") \
                or ranks[0]["params_sha"] != ranks[1]["params_sha"]:
            raise AssertionError(f"{what}: the model ranks report different losses, sweeps "
                                 "or parameters")
        flat = [v for x in h0["step_losses"] for v in (x.values() if isinstance(x, dict)
                                                       else [x])]
        if len(h0["step_losses"]) != TP_STEPS or not all(math.isfinite(v) for v in flat):
            raise AssertionError(f"{what}: losses {h0['step_losses']}")
        if not h0["checkpoint_path"] or h1["checkpoint_path"] is not None:
            raise AssertionError(f"{what}: checkpoints {h0['checkpoint_path']} "
                                 f"{h1['checkpoint_path']}: rank 0 alone writes")
        model_file = Path(h0["checkpoint_path"]) / "pytorch_model.bin"
        mod = importlib.import_module(f"k3m_tpu_torch.{cli}")
        config = mod.resolve_config(mod.get_parser().parse_args(argv))
        sha, shapes = _one_process_sha(lambda: model_class(config), model_file)
        if sha != ranks[0]["params_sha"]:
            raise AssertionError(f"{what}: {model_file} loaded into one process differs from "
                                 "the ranks' gathered parameters")
        model = [t.get("model", [0, 0, 0.0]) for t in ranks[0]["step_traffic"][1:]]
        entry = dict(step_losses=h0["step_losses"], launches=[r["launches"] for r in ranks],
                     expected=expected, peak_gib=[r["peak_gib"] for r in ranks],
                     step_ms=[1e3 * t for t in h0["step_seconds"][1:]],
                     model_allreduces=[m[0] for m in model],
                     model_allreduce_bytes=[m[1] for m in model],
                     model_allreduce_ms=[1e3 * m[2] for m in model],
                     model_file_tensors=len(shapes),
                     word_table=shapes["embeddings.word_embeddings.weight"])
        note = ""
        if cli == "finetune":
            entry["sweep"] = h0["sweep"]
            if ranks[1]["output"] is not None or ranks[0]["output"].endswith(".part0"):
                raise AssertionError(f"{what}: predict files {ranks[0]['output']} "
                                     f"{ranks[1]['output']}")
            read = lambda p: {(x["src_item_id"], x["tgt_item_id"]): x
                              for x in map(json.loads, Path(p).read_text().splitlines())}
            part, want = read(ranks[0]["output"]), read(one["output"])
            if len(part) != TP_EVAL_PAIRS or set(want) != set(part):
                raise AssertionError(f"{what}: {len(part)} predicted pairs, {len(want)} in "
                                     "one process's predict")
            entry["worst_score_diff"] = max(
                abs(float(part[k][s]) - float(x[s])) for k, x in want.items()
                for s in ("src_item_emb", "tgt_item_emb"))
            if entry["worst_score_diff"] > DP_BF16_TOL:
                raise AssertionError(f"{what}: scores differ from one process's by "
                                     f"{entry['worst_score_diff']}")
            note = (f"; predict of {TP_EVAL_PAIRS} pairs within "
                    f"{entry['worst_score_diff']:.3e} of one process's")
        log(f"{what}: two model ranks on one card over gloo (three CLIs at once): losses "
            f"equal on both, {TP_STEPS} steps, step ms {[round(x, 1) for x in entry['step_ms']]}; "
            f"a step's model-group all-reduces {entry['model_allreduces']} of "
            f"{[round(b / 2 ** 20, 1) for b in entry['model_allreduce_bytes']]} MiB in "
            f"{[round(x, 1) for x in entry['model_allreduce_ms']]} host ms (host copies and "
            f"gloo over loopback); peak memory {[round(x, 2) for x in entry['peak_gib']]} GiB "
            f"per rank; launches {ranks[0]['launches']} on each; {model_file.name}: "
            f"{len(shapes)} tensors at full shape (word table {entry['word_table']}), loads "
            f"into one process bit for bit{note} | {card}")
        shutil.rmtree(Path(argv[argv.index("--output_dir") + 1]), ignore_errors=True)
        res[cli] = entry
        res[f"{cli}_launches"] = {f"gloo{r}": ranks[r]["launches"] for r in range(2)}
    for p in (data, ft_data, WORK / "tp_predict_one"):
        shutil.rmtree(p, ignore_errors=True)
    return res


def phase_tp_cards(card, n):
    """`k3m_tpu_torch.pretrain` at full width (k3m_roberta_base, bf16,
    global batch 96, TP_CARDS_STEPS steps) on one card, then as n NCCL
    ranks one per card with --n_model n, and on 4 cards also as 2 data
    groups x 2 model ranks (torchrun's variables). The ranks of a run must
    report the same losses and gathered parameters, the losses within
    2^-6 of one card's (bf16 sums in another order); global samples/s and
    step ms over the steps after the first, the model-group all-reduces'
    bytes and host ms a step (the NCCL enqueue), rank 0's profiled step
    (device busy ms, the NCCL kernels' device ms), peak memory per rank.
    `python3 chip_smoke.py --tp-cards N` runs it alone, on N cards."""
    if torch.cuda.device_count() < n:
        raise AssertionError(f"tp_cards: {torch.cuda.device_count()} cards, {n} asked for")
    data = WORK / "tp_cards_data"
    data.mkdir(parents=True, exist_ok=True)
    write_pretrain_records(data / "train_feat.k3mr", TP_CARDS_STEPS * TRAIN_BATCH)
    spec = dict(mode="cli", cli="pretrain", card=card,
                profile=(str(data / "train_feat.k3mr"), TRAIN_BATCH))
    layouts = [(1, 1), (n, n)] + ([(4, 2)] if n == 4 else [])
    res, ref = {}, None
    for size, M in layouts:
        tag = f"{size // M}x{M}"
        argv = _pretrain_argv(data, WORK / f"tp_cards_{tag}", "--n_model", str(M))
        port = _free_port()
        jobs = [(f"tp_cards_{tag}_{r}", dict(spec, argv=argv),
                 _dp_env("plain") if size == 1 else
                 _dp_env("torchrun", r, size, port, local_rank=r)) for r in range(size)]
        got = run_workers(jobs, "tp_cards")
        ranks = [got[f"tp_cards_{tag}_{r}"] for r in range(size)]
        hs = [r["history"] for r in ranks]
        if any(h["step_losses"] != hs[0]["step_losses"] for h in hs) or \
                len({r["params_sha"] for r in ranks}) != 1:
            raise AssertionError(f"tp_cards {tag}: the ranks differ in losses or parameters")
        losses = [x["loss"] for x in hs[0]["step_losses"]]
        if len(losses) != TP_CARDS_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"tp_cards {tag}: losses {losses}")
        if ref is None:
            ref = losses
        errs = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses, ref)]
        if max(errs) > DP_BF16_TOL:
            raise AssertionError(f"tp_cards {tag}: losses {losses} off one card's {ref}")
        timed = hs[0]["step_seconds"][1:]
        model = [t.get("model", [0, 0, 0.0]) for t in ranks[0]["step_traffic"][1:]]
        prof = ranks[0]["profile"]
        r = dict(samples_per_s=(size // M) * sum(hs[0]["step_samples"][1:]) / sum(timed),
                 step_ms=[1e3 * t for t in timed], losses=losses, worst_loss_err=max(errs),
                 model_allreduce_bytes=np.mean([m[1] for m in model]),
                 model_allreduce_host_ms=np.mean([1e3 * m[2] for m in model]),
                 busy_ms=prof["busy_ms"], nccl_device_ms=prof["nccl_ms"],
                 profiled_wall_ms=prof["wall_ms_profiled"],
                 peak_gib=[x["peak_gib"] for x in ranks])
        log(f"tp_cards: {size} rank(s), {size // M} data x {M} model: {r['samples_per_s']:.2f} "
            f"global samples/s, step ms mean {np.mean(r['step_ms']):.2f}; model-group "
            f"all-reduces {r['model_allreduce_bytes'] / 2 ** 30:.3f} GiB a step, host "
            f"(enqueue) {r['model_allreduce_host_ms']:.2f} ms; rank 0's profiled step: busy "
            f"{r['busy_ms']:.2f} ms, NCCL kernels {r['nccl_device_ms']:.2f} ms, wall "
            f"{r['profiled_wall_ms']:.2f} ms; losses within {r['worst_loss_err']:.3e} of one "
            f"card's; peak memory per rank {[round(x, 2) for x in r['peak_gib']]} GiB "
            f"| {card} (x{size})")
        res[tag] = r
        shutil.rmtree(WORK / f"tp_cards_{tag}", ignore_errors=True)
    shutil.rmtree(data, ignore_errors=True)
    return dict(res, n=n)


# ------------------------------------------------- trunk options (phase 24)

OPTION_ATTN_SHAPES = ((12, 51, 64, "title+task"), (12, 257, 64, "pv+task"),
                      (12, 87, 64, "basebert"))
OPTION_BIATTN_SHAPES = ((37, 51, 128, "c_layer task"), (37, 257, 128, "c_layer_pv_v task"),
                        (257, 51, 96, "c_layer_pv_t task"))
OPTION_BATCH = 8            # (a)-(c); (c) makes 64 pair rows of it
MAPS_BATCH = 4              # (d)
CROSS_BATCH = 2             # every part's fp32 card-vs-CPU cross-check
BASEBERT_BATCH = 32         # (e)
BASEBERT_STEPS = 3


def option_kernel_rows(card):
    """#1-#5 at the shapes the trunk options and the single-stream baseline
    give them, at batch 96, fp32 and bf16 at rate 0 and 0.1, held and timed
    as phase 3 holds them: the task token's L51 and L257 (one row past four
    64-row tiles, nine mask words, held bit for bit to the plain mask), the
    baseline's L87 (50 title + 37 image tokens), the co-attention at
    37<->51, 37<->257 and 257<->51; #1/#2 on the 96 x 257 pv rows of 768."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, rows = TRAIN_BATCH, []
    ln = ((B * 257, 768, "pv+task"),)
    kernel_phase_layernorm(card, rows, cases=[(B, s, ((f32, f32), (bf16, bf16))) for s in ln])
    kernel_phase_layernorm_bwd(card, rows, cases=[(B, s, (f32, bf16)) for s in ln])
    cases = [(B, dt, rate) for dt in (f32, bf16) for rate in RATES]
    kernel_phase_attention(card, rows, cases=cases, shapes=OPTION_ATTN_SHAPES)
    kernel_phase_biattention(card, rows, cases=cases, shapes=OPTION_BIATTN_SHAPES)
    kernel_phase_attention_bwd(card, rows, runs=((B, (f32, bf16), RATES),),
                               attn_shapes=OPTION_ATTN_SHAPES, bi_shapes=OPTION_BIATTN_SHAPES)
    torch.cuda.empty_cache()
    return rows


def _check_launches(what, got, want, card):
    from k3m_tpu_torch import kernels
    want = {k: want.get(k, 0) for k in kernels.WRAPPERS}
    log(f"{what}: kernel launches {got} | {card}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, the config gives {want}")
    vector_ln_only(what, card)


def _seeded(make, cfg, device, states):
    """`make()` with random weights from SEED (drawn once per parameter
    layout into `states`, then copied), computing in the config's dtype,
    on `device`."""
    from k3m_tpu_torch.model.layers import compute_dtype, init_weights, set_compute_dtype
    with torch.device("meta"):
        module = make()
    key = tuple((k, tuple(v.shape)) for k, v in module.state_dict().items())
    if key not in states:
        states[key] = init_weights(make(), SEED, cfg.initializer_range).state_dict()
    module.load_state_dict({k: v.clone() for k, v in states[key].items()}, assign=True)
    return set_compute_dtype(module, compute_dtype(cfg)).to(device)


def _ragged(rng, b, n):
    m = np.ones((b, n), np.int64)
    for i in range(1, b):
        m[i, rng.integers(n // 2, n):] = 0
    return m


def _trunk_inputs(cfg, B, seed, device, task=False):
    """K3MTrunk's positional inputs at the full shapes (title 50, pv 256,
    36 RoIs and the global token), ragged masks, on `device`; with `task`,
    the task ids."""
    rng = np.random.default_rng(seed)
    L, Lpv, R = SHAPES["max_seq_length"], SHAPES["max_seq_length_pv"], \
        SHAPES["max_region_length"] + 1
    ids = lambda n: torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, n)))
    args = [ids(L), torch.from_numpy(rng.standard_normal((B, R, cfg.v_feature_size))).float(),
            torch.from_numpy(rng.random((B, R, 5))).float(), torch.zeros(B, L, dtype=torch.long),
            torch.from_numpy(_ragged(rng, B, L)), torch.from_numpy(_ragged(rng, B, R)),
            ids(Lpv), torch.zeros(B, Lpv, dtype=torch.long),
            torch.from_numpy(_ragged(rng, B, Lpv))]
    kw = dict(task_ids=torch.from_numpy(rng.integers(0, 20, (B,)))) if task else {}
    to = lambda t: t.to(device)
    return [to(a) for a in args], {k: to(v) for k, v in kw.items()}


def _encoder_inputs(cfg, Bt, B, seed, device, dtype, grad=False):
    """TriStreamEncoder's inputs at the full shapes: text embeddings of Bt
    rows, image and pv embeddings of B rows (N(0, 1) in `dtype`; leaves
    with a gradient under `grad`), their fp32 key biases and the [B, L, 1]
    text masks."""
    from k3m_tpu_torch.model.layers import mask_to_bias
    rng = np.random.default_rng(seed)
    L, Lpv, R = SHAPES["max_seq_length"], SHAPES["max_seq_length_pv"], \
        SHAPES["max_region_length"] + 1

    def emb(b, n, h):
        t = torch.from_numpy(rng.standard_normal((b, n, h))).to(device, dtype)
        return t.requires_grad_(grad)
    txt, img, pv = emb(Bt, L, cfg.hidden_size), emb(B, R, cfg.v_hidden_size), \
        emb(B, Lpv, cfg.hidden_size)
    tm, im, pm = (torch.from_numpy(_ragged(rng, b, n)).to(device)
                  for b, n in ((Bt, L), (B, R), (B, Lpv)))
    return [txt, img, mask_to_bias(tm), tm.to(dtype)[:, :, None], mask_to_bias(im), pv,
            mask_to_bias(pm), pm.to(dtype)[:, :, None]]


def _probe_loss(outs):
    """sum_i <outs[i], r_i> with r_i ~ N(0, 1) drawn on the CPU from seed
    i, the same on every device: a loss whose gradient reaches every
    weight (a plain sum would not pass a LayerNorm with uniform scales:
    its normalized rows sum to zero)."""
    total = 0.0
    for i, o in enumerate(outs):
        r = torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
        total = total + (o.float() * r.to(o.device)).sum()
    return total


def _train_pass(model, run, card, what, want, dev):
    """One bf16 training forward (dropout 0.1 from a StepRandom) and its
    backward of `_probe_loss` of `run(model)`'s outputs: finite outputs,
    the launch counts the config gives. Returns the seconds."""
    from k3m_tpu_torch import kernels
    from k3m_tpu_torch.model import random as k3m_random
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with k3m_random.use(k3m_random.StepRandom(SEED, 0, dev)):
        outs = run(model)
        loss = _probe_loss(outs)
    loss.backward()
    _sync(dev)
    seconds = time.perf_counter() - t0
    if not all(torch.isfinite(o).all() for o in outs) or not torch.isfinite(loss):
        raise AssertionError(f"{what}: non-finite outputs")
    _check_launches(what, kernels.launch_counts(), want, card)
    return seconds


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


KEY_BIAS = re.compile(r"(key[12]?)\.bias$")


def _hold(what, want, got, kind, card):
    """`got` against `want` tensor by tensor: outputs at phase 5's limit
    (1e-4 of max(1, scale)), gradients at phase 7's (1e-3 of the tensor's
    scale + 1e-7). A key projection's bias has a gradient that is zero in
    exact arithmetic (it adds q . b_k to every key of a query alike, which
    the softmax ignores), so only rounding remains there: it is held at
    its weight's gradient scale, as phases 9 and 18 hold struc_w2.bias at
    struc_w2.weight's. Returns the worst error/tolerance."""
    if set(want) != set(got) or not want:
        raise AssertionError(f"{what}: the two runs gave different {kind}s")
    worst, worst_name = 0.0, None
    for name, a in want.items():
        b = got[name]
        scale = want[KEY_BIAS.sub(r"\1.weight", name)] if kind == "gradient" \
            and KEY_BIAS.search(name) else a
        tol = (1e-4 * max(1.0, float(a.abs().max())) if kind == "output"
               else 1e-3 * float(scale.abs().max()) + 1e-7)
        ratio = max_err(a, b) / tol
        if ratio > worst:
            worst, worst_name = ratio, name
        if not (torch.isfinite(b).all() and ratio <= 1.0):
            raise AssertionError(f"{what} {kind} {name}: {max_err(a, b)} > {tol}")
    log(f"{what}: {len(want)} {kind}s agree; worst error/tolerance {worst:.3e} "
        f"({worst_name}) | {card}")
    return worst


def _outputs(outs):
    """{out<i>: tensor} of a module's outputs (a dict's in key order, the
    word table left out: it is a parameter)."""
    if isinstance(outs, dict):
        outs = [outs[k] for k in sorted(outs) if k != "word_embedding_table"]
    return {f"out{i}": o for i, o in enumerate(outs)}


def _fp32_run(build, inputs, device, grads_of_inputs=()):
    """fp32 deterministic forward and backward of `_probe_loss` of the
    outputs of `build(device)(*inputs(device))`: ({output: tensor},
    {parameter or input<i>: gradient}), on the host."""
    model = build(device)
    args = inputs(device)
    outs = _outputs(model(*args))
    _probe_loss(list(outs.values())).backward()
    got = {k: o.detach().float().cpu() for k, o in outs.items()}
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters() if p.grad is not None}
    grads.update({f"input{i}": args[i].grad.float().cpu() for i in grads_of_inputs})
    del model, args, outs
    torch.cuda.empty_cache()
    return got, grads


class _ReluBranches:
    """`torch.relu` (model/fusion.py) for the fp32 cross-checks. Its
    gradient jumps at 0: an input that rounding puts on either side of 0
    (within ~1e-6 in an fp32 trunk) sends the whole upstream gradient down
    one branch or the other, and either is right. So the card's run records
    each call's branches ("record"), and the CPU's run ("replay") takes the
    card's branch wherever its own input lies within the output check's
    limit of 0 (1e-4 of max(1, the input's scale)); everywhere else the
    CPU's relu stands. `decided` counts the inputs whose branch the card's
    record changed."""

    def __init__(self):
        self.relu, self.signs, self.decided = torch.relu, [], 0

    @contextlib.contextmanager
    def use(self, mode):
        self.mode, self.calls = mode, 0
        torch.relu = self._relu
        try:
            yield
        finally:
            torch.relu = self.relu
        if mode == "replay" and self.calls != len(self.signs):
            raise AssertionError(f"relu: {self.calls} calls on the CPU, {len(self.signs)} "
                                 "on the card")

    def _relu(self, x):
        if self.mode == "record":
            self.signs.append((x.detach() > 0).cpu())
            return self.relu(x)
        card_pos = self.signs[self.calls].to(x.device)
        self.calls += 1
        if card_pos.shape != x.shape:
            raise AssertionError(f"relu: input {tuple(x.shape)} on the CPU, "
                                 f"{tuple(card_pos.shape)} on the card")
        v = x.detach()
        near = v.abs() <= 1e-4 * max(1.0, float(v.abs().max()))
        self.decided += int((near & ((v > 0) != card_pos)).sum())
        return torch.where(near, x * card_pos.to(x.dtype), self.relu(x))


def _cross(what, build, inputs, card, dev, grads_of_inputs=()):
    """The fp32 cross-check of one part at CROSS_BATCH: `dev` (the card)
    against the CPU, outputs and every gradient, the CPU's relu taking the
    card's branch where its input is within rounding of 0
    (`_ReluBranches`)."""
    branches = _ReluBranches()
    with branches.use("record"):
        card_ = _fp32_run(build, inputs, dev, grads_of_inputs)
    with branches.use("replay"):
        cpu = _fp32_run(build, inputs, "cpu", grads_of_inputs)
    log(f"{what}: {len(branches.signs)} relu calls, {branches.decided} inputs within "
        f"rounding of 0 on the card's branch | {card}")
    return dict(outputs=_hold(f"{what} fp32 card vs cpu", cpu[0], card_[0], "output", card),
                grads=_hold(f"{what} fp32 card vs cpu", cpu[1], card_[1], "gradient", card),
                relu_calls=len(branches.signs), relu_decided_by_card=branches.decided)


def _no_grad_outputs(model, *args):
    with torch.no_grad():
        return {k: v.float().cpu() for k, v in _outputs(model(*args)).items()}


class _TaskTrunk(torch.nn.Module):
    """K3MTrunk called positionally with its keywords last (deterministic,
    gumbel_noise, task_ids), as the cross-checks call every part."""

    def __init__(self, cfg):
        super().__init__()
        from k3m_tpu_torch.model.pretrain import K3MTrunk
        self.trunk = K3MTrunk(cfg)

    def forward(self, *args):
        *a, det, noise, task = args
        return self.trunk(*a, deterministic=det, gumbel_noise=noise, task_ids=task)


def _options_task_tokens(card, dev, states):
    """(a) K3MTrunk with task_ids (bert_base_6layer_6conect): a bf16
    training pass at OPTION_BATCH, both text streams one longer (51 and
    257); the fp32 cross-check (soft fusion, no Gumbel draw)."""
    from k3m_tpu_torch.config import K3MConfig
    cfg = K3MConfig.from_json_file(str(BERT)).replace(use_image=True,
                                                      task_specific_tokens=True)
    bf = cfg.replace(dtype="bfloat16")
    model = _seeded(lambda: _TaskTrunk(bf), bf, dev, states)
    args, kw = _trunk_inputs(bf, OPTION_BATCH, SEED + 30, dev, task=True)
    shapes = {}

    def run(m):
        out = m(*args, False, None, kw["task_ids"])
        shapes.update(seq_t=out["seq_t"].shape[1], seq_pv=out["seq_pv"].shape[1])
        return list(_outputs(out).values())
    seconds = _train_pass(model, run, card, "options (a) task tokens bf16",
                          expected_train_launches(bf, 1, head_lns=0), dev)
    want = dict(seq_t=SHAPES["max_seq_length"] + 1, seq_pv=SHAPES["max_seq_length_pv"] + 1)
    if shapes != want:
        raise AssertionError(f"options (a): text streams {shapes} long, not {want}")
    del model
    soft = cfg.replace(if_pre_sampling=2)

    def inputs(d):
        a, k = _trunk_inputs(soft, CROSS_BATCH, SEED + 31, d, task=True)
        return a + [True, None, k["task_ids"]]
    return dict(bf16_seconds=seconds, lengths=shapes,
                cross=_cross("options (a) task tokens",
                             lambda d: _seeded(lambda: _TaskTrunk(soft), soft, d, states),
                             inputs, card, dev))


def _plain_encoder(cfg, model):
    """An encoder without the row options, holding `model`'s weights."""
    from k3m_tpu_torch.model.encoder import TriStreamEncoder
    from k3m_tpu_torch.model.layers import compute_dtype, set_compute_dtype
    with torch.device("meta"):
        plain = TriStreamEncoder(cfg.replace(fast_mode=False, in_batch_pairs=False))
    plain.load_state_dict(model.state_dict(), assign=True)
    return set_compute_dtype(plain, compute_dtype(cfg)).eval()


def _options_fast_mode(card, dev, states):
    """(b) TriStreamEncoder with fast_mode (k3m_roberta_base): bf16
    training passes at equal batches (8) and at a text batch of 1 against
    8 images and pvs; fp32 on the card, held to the encoder fed the text
    row repeated; the fp32 cross-check at a text batch of 1 against 2."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.encoder import TriStreamEncoder
    cfg = K3MConfig.from_json_file(str(ROBERTA)).replace(use_image=True, fast_mode=True)
    bf = cfg.replace(dtype="bfloat16")
    model = _seeded(lambda: TriStreamEncoder(bf), bf, dev, states)
    out = {}
    for Bt in (OPTION_BATCH, 1):
        args = _encoder_inputs(bf, Bt, OPTION_BATCH, SEED + 40 + Bt, dev, torch.bfloat16,
                               grad=True)
        out[f"bf16_seconds_text{Bt}"] = _train_pass(
            model, lambda m: m(*args, False), card,
            f"options (b) fast mode bf16 text {Bt} x {OPTION_BATCH}",
            expected_train_launches(bf, 1, head_lns=0, embedding_lns=0), dev)
    del model, args
    model = _seeded(lambda: TriStreamEncoder(cfg), cfg, dev, states).eval()
    args = _encoder_inputs(cfg, 1, OPTION_BATCH, SEED + 42, dev, torch.float32)
    rep = [a.expand((OPTION_BATCH,) + tuple(a.shape[1:])).contiguous() if i in (0, 2, 3)
           else a for i, a in enumerate(args)]
    out["repeat_worst"] = _hold("options (b) fast mode vs the text row repeated (fp32)",
                                _no_grad_outputs(_plain_encoder(cfg, model), *rep),
                                _no_grad_outputs(model, *args), "output", card)
    del model, args, rep
    inputs = lambda d: _encoder_inputs(cfg, 1, CROSS_BATCH, SEED + 43, d, torch.float32,
                                       grad=True) + [True]
    out["cross"] = _cross("options (b) fast mode",
                          lambda d: _seeded(lambda: TriStreamEncoder(cfg), cfg, d, states),
                          inputs, card, dev, (0, 1, 5))
    return out


def _options_pairs(card, dev, states):
    """(c) TriStreamEncoder with in_batch_pairs (k3m_roberta_base): a bf16
    training pass at b 8 (64 pair rows); fp32 on the card, held per pass to
    the encoder fed the text side's rows repeated and the other stream's
    tiled (t<->v and pv<->v: text and pv repeated, images tiled; t<->pv:
    text repeated, pv tiled); the fp32 cross-check at b 2."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.encoder import TriStreamEncoder
    cfg = K3MConfig.from_json_file(str(ROBERTA)).replace(use_image=True, in_batch_pairs=True)
    bf = cfg.replace(dtype="bfloat16")
    b = OPTION_BATCH
    model = _seeded(lambda: TriStreamEncoder(bf), bf, dev, states)
    args = _encoder_inputs(bf, b, b, SEED + 50, dev, torch.bfloat16, grad=True)
    rows = []

    def run(m):
        outs = m(*args, False)
        rows.extend(o.shape[0] for o in outs)
        return outs
    out = dict(bf16_seconds=_train_pass(model, run, card,
                                        f"options (c) in-batch pairs bf16 b {b}",
                                        expected_train_launches(bf, 1, head_lns=0, embedding_lns=0), dev))
    if rows != [b * b] * 6:
        raise AssertionError(f"options (c): rows {rows}, not {b * b}")
    del model, args
    torch.cuda.empty_cache()
    model = _seeded(lambda: TriStreamEncoder(cfg), cfg, dev, states).eval()
    plain = _plain_encoder(cfg, model)
    txt, img, tb, tm2, ib, pv, pb, pm2 = args = _encoder_inputs(cfg, b, b, SEED + 51, dev,
                                                                 torch.float32)
    rep = lambda t: t.repeat_interleave(b, dim=0)
    tile = lambda t: t.repeat((b,) + (1,) * (t.dim() - 1))
    got = _no_grad_outputs(model, *args)
    with_img = _no_grad_outputs(plain, rep(txt), tile(img), rep(tb), rep(tm2), tile(ib),
                                rep(pv), rep(pb), rep(pm2))
    two_text = _no_grad_outputs(plain, rep(txt), tile(img), rep(tb), rep(tm2), tile(ib),
                                tile(pv), tile(pb), tile(pm2))
    want = {k: (with_img if int(k[3:]) < 4 else two_text)[k] for k in got}
    out["repeat_worst"] = _hold("options (c) in-batch pairs vs the rows repeated and tiled "
                                "(fp32)", want, got, "output", card)
    del model, plain, args, got, with_img, two_text, want
    torch.cuda.empty_cache()
    inputs = lambda d: _encoder_inputs(cfg, CROSS_BATCH, CROSS_BATCH, SEED + 52, d,
                                       torch.float32, grad=True) + [True]
    out["cross"] = _cross("options (c) in-batch pairs",
                          lambda d: _seeded(lambda: TriStreamEncoder(cfg), cfg, d, states),
                          inputs, card, dev, (0, 1, 5))
    return out


def _options_maps(card, dev, states):
    """(d) forward_with_attention on K3MTrunk (bert_base_6layer_6conect
    with visualization, soft fusion) at MAPS_BATCH in bf16: as many maps
    per site as the JAX package sows (4 per text layer, 2 per image layer,
    attn1 and attn2 once per co-attention layer), each row summing to 1
    within 2e-2 (the JAX test's limit), no attention kernel launched and
    the LN kernel at its count; in fp32 the outputs equal the kernel
    path's (visualization off) at phase 5's limit."""
    from k3m_tpu_torch import kernels
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.pretrain import K3MTrunk
    from k3m_tpu_torch.model.visualize import flatten_attention, forward_with_attention
    cfg = K3MConfig.from_json_file(str(BERT)).replace(use_image=True, visualization=True,
                                                      if_pre_sampling=2)
    bf = cfg.replace(dtype="bfloat16")
    model = _seeded(lambda: K3MTrunk(bf), bf, dev, states).eval()
    args, _ = _trunk_inputs(bf, MAPS_BATCH, SEED + 60, dev)
    kernels.reset_launch_counts()
    with torch.no_grad():
        _, maps = forward_with_attention(model, *args)
    _sync(dev)
    _check_launches("options (d) attention maps bf16", kernels.launch_counts(),
                    dict(fused_layernorm=expected_launches(bf, 1)["fused_layernorm"]), card)
    counts = {p: {n: len(v) for n, v in s.items()} for p, s in maps.items()}
    want = {**{f"encoder.layer.{i}.attention.self": {"attention_probs": 4}
               for i in range(cfg.num_hidden_layers)},
            **{f"encoder.v_layer.{i}.attention.self": {"attention_probs": 2}
               for i in range(cfg.v_num_hidden_layers)},
            **{f"encoder.{s}.{i}.biattention": {"attn1": 1, "attn2": 1}
               for s in ("c_layer", "c_layer_pv_v", "c_layer_pv_t")
               for i in range(cfg.num_coattention_layers)}}
    if counts != want:
        raise AssertionError(f"options (d): maps per site {counts}, not {want}")
    flat = flatten_attention(maps)
    worst_row = 0.0
    for key, p in flat.items():
        err = float((p.float().sum(-1) - 1).abs().max())
        worst_row = max(worst_row, err)
        if p.dim() != 4 or not err <= 2e-2:
            raise AssertionError(f"options (d) {key}: rows sum to 1 within {err}")
    log(f"options (d): {len(flat)} maps at {len(maps)} sites, rows sum to 1 within "
        f"{worst_row:.3e} | {card}")
    del model, maps, flat
    model = _seeded(lambda: K3MTrunk(cfg), cfg, dev, states).eval()
    off = _seeded(lambda: K3MTrunk(cfg.replace(visualization=False)), cfg, dev, states).eval()
    args, _ = _trunk_inputs(cfg, MAPS_BATCH, SEED + 61, dev)
    with torch.no_grad():
        got = {k: v.float().cpu() for k, v in
               _outputs(forward_with_attention(model, *args)[0]).items()}
    worst = _hold("options (d) fp32 maps on vs the kernel path", _no_grad_outputs(off, *args),
                  got, "output", card)
    return dict(sites=len(counts), maps=sum(sum(c.values()) for c in counts.values()),
                worst_row_sum_err=worst_row, fp32_vs_kernels=worst)


def _basebert_batch(cfg, B, seed, device):
    """The baseline's inputs at bert_base's title of 50 and 37 image tokens:
    ragged masks, soft labels over v_target_size, about 15% of the tokens
    and RoIs masked."""
    rng = np.random.default_rng(seed)
    L, R = SHAPES["max_seq_length"], SHAPES["max_region_length"] + 1
    tgt = rng.random((B, R - 1, cfg.v_target_size)).astype(np.float32)
    tgt /= tgt.sum(-1, keepdims=True)
    x = dict(input_ids=rng.integers(1, cfg.vocab_size, (B, L)),
             image_feat=rng.standard_normal((B, R, cfg.v_feature_size)).astype(np.float32),
             image_target=tgt, image_loc=rng.random((B, R, 5)).astype(np.float32),
             token_type_ids=np.zeros((B, L), np.int64), attention_mask=_ragged(rng, B, L),
             image_attention_mask=_ragged(rng, B, R),
             masked_lm_labels=np.where(rng.random((B, L)) < 0.15,
                                       rng.integers(1, cfg.vocab_size, (B, L)), -1),
             image_label=np.where(rng.random((B, R - 1)) < 0.15, 1, -1),
             next_sentence_label=rng.integers(0, 2, (B,)))
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


class _BaseBertLosses(torch.nn.Module):
    """BaseBertForPretraining on a batch dict, called positionally."""

    def __init__(self, cfg):
        super().__init__()
        from k3m_tpu_torch.model.basebert import BaseBertForPretraining
        self.model = BaseBertForPretraining(cfg)

    def forward(self, batch, det=True, rng=None):
        return list(self.model(**batch, deterministic=det, rng=rng))


def _options_basebert(card, dev, states):
    """(e) BaseBertForPretraining at the bert_base text geometry (12 layers
    of 768, 12 heads) with v_hidden_size 768: BASEBERT_STEPS bf16 AdamW
    steps at BASEBERT_BATCH (dropout 0.1), finite losses, every kernel at
    the count a step gives (28 LNs: 2 embeddings, 2 a layer, 2 heads; 12
    attentions; each with its backward); the fp32 cross-check at batch 2:
    the three losses and every gradient."""
    from k3m_tpu_torch import kernels
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.random import StepRandom
    cfg = K3MConfig.from_json_file(str(BERT))
    cfg = cfg.replace(v_hidden_size=cfg.hidden_size,
                      v_num_attention_heads=cfg.num_attention_heads)
    bf = cfg.replace(dtype="bfloat16")
    model = _seeded(lambda: _BaseBertLosses(bf), bf, dev, states)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.98))
    batch = _basebert_batch(bf, BASEBERT_BATCH, SEED + 70, dev)
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for step in range(BASEBERT_STEPS):
        t0 = time.perf_counter()
        out = model(batch, False, StepRandom(SEED, step, dev))
        sum(out).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append([v.item() for v in out])
        step_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for s in losses for v in s):
        raise AssertionError(f"options (e) basebert: non-finite losses {losses}")
    n_ln, n_at = 2 + 2 * cfg.num_hidden_layers + 2, cfg.num_hidden_layers
    _check_launches("options (e) basebert bf16", kernels.launch_counts(),
                    {k: BASEBERT_STEPS * v for k, v in dict(
                        fused_layernorm=n_ln, layernorm_bwd=n_ln, fused_attention=n_at,
                        attention_bwd=n_at).items()}, card)
    log(f"options (e) basebert: losses (mlm, img, nsp) {losses}, step s {step_s} | {card}")
    del model, opt, batch
    torch.cuda.empty_cache()
    cross = _cross("options (e) basebert",
                   lambda d: _seeded(lambda: _BaseBertLosses(cfg), cfg, d, states),
                   lambda d: [_basebert_batch(cfg, CROSS_BATCH, SEED + 71, d)], card, dev)
    return dict(losses=losses, step_seconds=step_s, cross=cross)


def phase_trunk_options(card, dev="cuda"):
    """Phase 24: the trunk options at full width, each once in bf16 with
    its launch counts and cross-checked in fp32 card vs CPU at batch 2:
    (a) task tokens, (b) fast mode, (c) in-batch pairs, (d) attention maps,
    (e) the single-stream baseline."""
    out, states = {}, {}
    for name, part in (("task_tokens", _options_task_tokens), ("fast_mode", _options_fast_mode),
                       ("in_batch_pairs", _options_pairs), ("attention_maps", _options_maps),
                       ("basebert", _options_basebert)):
        t0 = time.perf_counter()
        out[name] = part(card, dev, states)
        out[name]["seconds"] = time.perf_counter() - t0
        log(f"options {name}: {out[name]['seconds']:.1f} s")
        torch.cuda.empty_cache()
    return out


# --------------------------------- packed passes and fused QKV (phase 25)

PACKED_TEXT = (50, 256, 50, 256)   # packed_passes' text streams [t, pv, t, pv]
PACKED_ATTN_SHAPES = ((12, 50, 64, "title packed+fused"), (12, 256, 64, "pv packed+fused"))
PACKED_IMAGE_SHAPES = ((8, 37, 128, "image 2B"),)
PACKED_FLAGS = {"packed": dict(packed_passes=True), "fused": dict(fused_qkv=True),
                "packed+fused": dict(packed_passes=True, fused_qkv=True)}
PACKED_STEPS = 5           # steps of each run of (c) and (d), the first a warm-up
PACKED_CROSS_BATCH = 4     # (b)


def _packed_qkv(B, L, H, D, dtype, g):
    """q, k, v of the last text stream of length L among PACKED_TEXT as
    views of one fused [B * sum PACKED_TEXT, 3 * H * D] projection of the
    packed rows, at that stream's row offset (row stride 3 * H * D), as
    packed_passes with fused_qkv hands them to the kernels."""
    i = len(PACKED_TEXT) - 1 - PACKED_TEXT[::-1].index(L)
    o = B * sum(PACKED_TEXT[:i])
    rows = torch.randn(B * sum(PACKED_TEXT), 3 * H * D, generator=g, device="cuda").to(dtype)
    view = rows[o:o + B * L].view(B, L, 3, H, D)
    return view[:, :, 0], view[:, :, 1], view[:, :, 2]


def packed_kernel_rows(card):
    """#1-#4 at the shapes packed_passes and fused_qkv give them, fp32 and
    bf16 at rate 0 and 0.1, held and timed as phase 3 holds them: #1/#2 on
    the packed text rows of the pretraining batch ([96 * 612, 768], 612 =
    50 + 256 + 50 + 256) and of the finetune batch ([32 * 612, 768]), and
    on the image stack's [2 * 96 * 37, 1024] rows; #3/#4 at H8 L37 D128 on
    the image stack's 192 rows (one process's mask rows 0-191, bit for
    bit), and at H12 D64 L50 and L256 fed views of one [96 * 612, 2304]
    fused projection at their packed row offsets. #5 reads each stream's
    fused projection as phase 3's rows already lay it out (q, k, v views
    of one [B, L, 3, H, D] tensor)."""
    f32, bf16 = torch.float32, torch.bfloat16
    n, rows = sum(PACKED_TEXT), []
    ln = ((TRAIN_BATCH, (TRAIN_BATCH * n, 768, "packed text")),
          (FT_BATCH, (FT_BATCH * n, 768, "packed text")),
          (TRAIN_BATCH, (PACKED_IMAGE_BATCH * 37, 1024, "image 2B")))
    kernel_phase_layernorm(card, rows, cases=[(b, s, ((f32, f32), (bf16, bf16))) for b, s in ln])
    kernel_phase_layernorm_bwd(card, rows, cases=[(b, s, (f32, bf16)) for b, s in ln])
    cases = lambda B: [(B, dt, rate) for dt in (f32, bf16) for rate in RATES]
    kernel_phase_attention(card, rows, cases=cases(PACKED_IMAGE_BATCH),
                           shapes=PACKED_IMAGE_SHAPES)
    kernel_phase_attention(card, rows, cases=cases(TRAIN_BATCH), shapes=PACKED_ATTN_SHAPES,
                           qkv=_packed_qkv)
    kernel_phase_attention_bwd(card, rows, runs=((PACKED_IMAGE_BATCH, (f32, bf16), RATES),),
                               attn_shapes=PACKED_IMAGE_SHAPES, bi_shapes=())
    kernel_phase_attention_bwd(card, rows, runs=((TRAIN_BATCH, (f32, bf16), RATES),),
                               attn_shapes=PACKED_ATTN_SHAPES, bi_shapes=(), qkv=_packed_qkv)
    torch.cuda.empty_cache()
    return rows


def _packed_vs_sequential(card, flags, dev="cuda"):
    """(b): TriStreamEncoder (k3m_roberta_base as shipped, fp32, dropout 0)
    with `flags` against the sequential encoder, same seeded weights and
    inputs, both on the card: every output at phase 5's limit and every
    parameter's and input's gradient at phase 7's, each run's launches as
    layer_counts gives them (`dev` "cpu" rehearses it). Not under dynamic
    attention, where the packed schedule gates the image layers after the
    last co-attention block on other text rows (model/encoder.py)."""
    from k3m_tpu_torch import kernels
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.encoder import TriStreamEncoder
    base = K3MConfig.from_json_file(str(ROBERTA))
    states, runs = {}, {}
    B = PACKED_CROSS_BATCH
    for name, cfg in (("sequential", base), ("flags", base.replace(**flags))):
        kernels.reset_launch_counts()
        runs[name] = _fp32_run(lambda dev: _seeded(lambda: TriStreamEncoder(cfg), cfg, dev, states),
                               lambda dev: _encoder_inputs(cfg, B, B, SEED, dev, torch.float32,
                                                           grad=True), dev,
                               grads_of_inputs=(0, 1, 5))
        _check_launches(f"packed (b) {name}", kernels.launch_counts(),
                        expected_train_launches(cfg, 1, head_lns=0, embedding_lns=0), card)
    what = f"packed (b) {'+'.join(sorted(flags))} vs sequential on the card"
    return dict(outputs=_hold(what, runs["sequential"][0], runs["flags"][0], "output", card),
                grads=_hold(what, runs["sequential"][1], runs["flags"][1], "gradient", card))


def _flag_run(card, what, main, argv, cfg, expected_of, unit, profile_batch,
              producer="native"):
    """One CLI run of `main(argv)` (PACKED_STEPS steps) on the `producer`
    it must train on: finite losses, every kernel counter equal to
    `expected_of(steps)`, `unit`/s and step ms over the steps after the
    first, peak memory; then one more step of its trainer on
    `profile_batch(trainer)` under the profiler: launch calls and busy ms."""
    from k3m_tpu_torch import kernels
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if run["producer"] != producer:
        raise AssertionError(f"{what}: the train loader ran the {run['producer']} producer, "
                             f"not the {producer} one")
    (hist,) = run["history"]
    steps = len(hist["step_seconds"])
    if steps != PACKED_STEPS:
        raise AssertionError(f"{what}: {steps} steps, expected {PACKED_STEPS}")
    _check_launches(what, counts, expected_of(steps), card)
    losses = hist["step_losses"]
    flat = [v for x in losses for v in (x.values() if isinstance(x, dict) else [x])]
    if not all(math.isfinite(v) for v in flat):
        raise AssertionError(f"{what}: non-finite losses {losses}")
    n = hist[f"step_{unit}"]
    timed = hist["step_seconds"][1:]
    rate, step_ms = sum(n[1:]) / sum(timed), [1e3 * t for t in timed]
    log(f"{what}: {steps} steps, {rate:.2f} {unit}/s over steps 2-{steps}, step ms mean "
        f"{sum(step_ms) / len(step_ms):.2f} (first {1e3 * hist['step_seconds'][0]:.2f}); peak "
        f"memory {peak:.2f} GiB | {card}")
    trainer = run["trainer"]
    batch = profile_batch(trainer)
    prof = profile_device(lambda: trainer.train_step(batch), card, f"{what} step", n=1)
    log_busy_share(what, prof["busy_ms"], step_ms, card)
    if hist.get("checkpoint_path"):
        shutil.rmtree(hist["checkpoint_path"], ignore_errors=True)
    loader = run.get("loader")
    del run, trainer, batch
    torch.cuda.empty_cache()
    return {f"{unit}_per_s": rate, "step_ms": step_ms, "first_step_ms":
            1e3 * hist["step_seconds"][0], "peak_gib": peak, "launches": counts,
            "loader": loader, "busy_ms": prof["busy_ms"],
            "host_launch_calls": prof["host_launch_calls"],
            "idle_share": prof["idle_share"], "profile_complete": prof["complete"]}


def phase_packed(card, train_res):
    """Phase 25: (a) phase 7's fp32 train step with both flags, card vs
    CPU; (b) `_packed_vs_sequential` with both flags; (c) `python -m
    k3m_tpu_torch.pretrain --bf16 --use_image --train_batch_size 96`
    (k3m_roberta_base) through a --config_file that sets packed_passes,
    then fused_qkv, then both, PACKED_STEPS steps each, beside phase 6's
    run of the same CLI without them (`train_res`); (d) `finetune
    --do_train` (bert_base_6layer_6conect, batch 32, the flags of phase
    8) with both flags, PACKED_STEPS steps."""
    from k3m_tpu_torch import finetune, pretrain
    from k3m_tpu_torch.config import K3MConfig
    both = PACKED_FLAGS["packed+fused"]
    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["crosscheck"] = phase_train_crosscheck(card, both, "packed (a) train crosscheck")
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["vs_sequential"] = _packed_vs_sequential(card, both)
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data_dir = WORK / "packed_data"
    write_pretrain_records(data_dir / "train_feat.k3mr", PACKED_STEPS * TRAIN_BATCH)
    shipped = json.loads(ROBERTA.read_text())
    p = train_res["profile"]
    runs = {"off": dict(samples_per_s=train_res["samples_per_s"], step_ms=train_res["step_ms"],
                        peak_gib=train_res["peak_gib"], launches=train_res["launches"],
                        busy_ms=p["busy_ms"], host_launch_calls=p["host_launch_calls"],
                        steps=TRAIN_STEPS)}
    for name, flags in PACKED_FLAGS.items():
        cfg_name = f"k3m_roberta_base_{name.replace('+', '_')}.json"
        (data_dir / cfg_name).write_text(json.dumps(dict(shipped, **flags), indent=1))
        cfg = K3MConfig.from_json_file(str(data_dir / cfg_name))
        path = data_dir / "train_feat.k3mr"
        runs[name] = _flag_run(
            card, f"packed (c) pretrain {name}", pretrain.main,
            _pretrain_argv(data_dir, WORK / "packed_out", "--config_file", cfg_name), cfg,
            lambda steps, cfg=cfg: expected_train_launches(cfg, steps), "samples",
            lambda trainer, cfg=cfg, path=path: trainer.stage(next(iter(_pretrain_loader(
                path, cfg, TRAIN_BATCH)))))
        runs[name]["steps"] = PACKED_STEPS
    out["pretrain"] = runs
    seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ft_dir = WORK / "packed_finetune"
    ft_dir.mkdir(parents=True, exist_ok=True)
    write_finetune_records(ft_dir, n_train=PACKED_STEPS * FT_BATCH, n_valid=FT_BATCH)
    ft_cfg = ft_dir / "bert_base_6layer_6conect_packed_fused.json"
    ft_cfg.write_text(json.dumps(dict(json.loads(BERT.read_text()), **both), indent=1))
    cfg = K3MConfig.from_json_file(str(ft_cfg))
    argv = ["--data_dir", str(ft_dir), "--output_dir", str(WORK / "packed_ft_out"),
            "--config_file", str(ft_cfg), "--use_image", "--with_coattention", "--do_train",
            "--bf16", "--loss_type", "inner", "--if_pre_sampling", "1", "--train_batch_size",
            str(FT_BATCH), "--learning_rate", "5e-5", "--warmup_proportion", "0.3",
            "--num_train_epochs", "1", "--seed", str(SEED), "--log_steps", "1"]
    for k, v in SHAPES.items():
        argv += [f"--{k}", str(v)]
    out["finetune"] = _flag_run(
        card, "packed (d) finetune packed+fused", finetune.main, argv, cfg,
        lambda steps: expected_finetune_launches(cfg, steps, 0), "pairs",
        lambda trainer: trainer.stage(_load_batch(ft_dir / "train_item_alignment.k3mr", cfg,
                                                  FT_BATCH)))
    shutil.rmtree(WORK / "packed_ft_out", ignore_errors=True)
    shutil.rmtree(WORK / "packed_out", ignore_errors=True)
    seconds["d"] = time.perf_counter() - t0
    for name, r in runs.items():
        log(f"packed (c) {name}: {r['samples_per_s']:.2f} samples/s, step ms mean "
            f"{sum(r['step_ms']) / len(r['step_ms']):.2f}, launches {r['launches']}, "
            f"{r['host_launch_calls']} launch calls and {r['busy_ms']:.2f} busy ms of one "
            f"profiled step, peak {r['peak_gib']:.2f} GiB ({r['steps']} steps) | {card}")
    out["part_seconds"] = seconds
    log(f"packed: part seconds { {k: round(v, 1) for k, v in seconds.items()} }")
    return out


GRAIN_BATCHES = 4          # (b): the first batches each producer makes
GRAIN_WORKERS = 2          # (b), (c): --num_workers of the per-record path


def _grain_producer(loader, what, card):
    """The first GRAIN_BATCHES batches of one epoch of `loader`, its
    samples/s over all but the first (whose seconds hold the workers'
    start-up) and the first's seconds."""
    t0 = time.perf_counter()
    it = iter(loader)
    batches = [next(it)]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches += [next(it) for _ in range(GRAIN_BATCHES - 1)]
    rate = (GRAIN_BATCHES - 1) * loader.batch_size / (time.perf_counter() - t0)
    del it
    loader.close()
    log(f"grain (b) {what}: {rate:.2f} samples/s over batches 2-{GRAIN_BATCHES} of "
        f"{loader.batch_size}, the first in {first_s:.2f} s (host, the loader alone) | {card}")
    return batches, dict(samples_per_s=rate, first_batch_s=first_s)


def phase_grain(card, train_res):
    """Phase 26: (a) phase 6's records written to an ArrayRecord file by the
    port's writer and read back, every payload byte for byte the K3MR
    reader's; (b) GrainPretrainLoader at batch 96, shuffled: its first
    batches in-process, from GRAIN_WORKERS worker processes and from the
    native hybrid byte for byte equal; (c) `python -m k3m_tpu_torch.pretrain
    --bf16 --use_image --train_batch_size 96 --data_backend grain
    --num_workers 2` (k3m_roberta_base) for PACKED_STEPS steps on an
    .array_record with no .k3mr sibling (the worker path), beside phase
    6's run (`train_res`)."""
    import ctypes.util

    from k3m_tpu_torch import pretrain
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.data.array_record import ArrayRecordStore, ArrayRecordWriter, zstd
    from k3m_tpu_torch.data.grain_pipeline import GrainPretrainLoader
    from k3m_tpu_torch.data.records import RecordReader
    from k3m_tpu_torch.tokenization import get_tokenizer
    out, seconds = {}, {}
    t0 = time.perf_counter()
    lib = zstd()
    out["zstd"] = dict(find_library=ctypes.util.find_library("zstd"), loaded=lib._name,
                       version=lib.ZSTD_versionNumber())
    log(f"grain: libzstd {out['zstd']} (ctypes.util.find_library('zstd') and the library "
        "loaded)")
    k3mr = WORK / "pretrain_data" / "train_feat.k3mr"
    reader = RecordReader(str(k3mr))
    n = len(reader)
    data_dir = WORK / "grain_data"
    path = data_dir / "train_feat.array_record"
    t1 = time.perf_counter()
    with ArrayRecordWriter(str(path)) as w:
        for i in range(n):
            w.write_payload(reader.payload(i))
    write_s = time.perf_counter() - t1
    store = ArrayRecordStore(str(path))
    t1 = time.perf_counter()
    if len(store) != n:
        raise AssertionError(f"grain (a): {len(store)} records read back, {n} written")
    for i in range(n):
        if store.payload(i) != reader.payload(i):
            raise AssertionError(f"grain (a): record {i} differs from the K3MR reader's")
    read_s = time.perf_counter() - t1
    store.close()
    mb, k3mr_mb = path.stat().st_size / 1e6, k3mr.stat().st_size / 1e6
    log(f"grain (a): {n} full-width records written to an ArrayRecord file in {write_s:.2f} "
        f"s ({mb:.1f} MB, the .k3mr {k3mr_mb:.1f} MB), read back in {read_s:.2f} s, every "
        f"payload byte for byte the K3MR reader's (host) | {card}")
    out["write"] = dict(records=n, write_s=write_s, read_s=read_s, mb=mb, k3mr_mb=k3mr_mb)
    seconds["a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = K3MConfig.from_json_file(str(ROBERTA))
    tok = get_tokenizer(None, cfg.vocab_size)

    def loader(**kw):
        return GrainPretrainLoader(str(path), tok, _shapes(), batch_size=TRAIN_BATCH,
                                   shuffle=True, seed=SEED, **kw)
    runs = {}
    for what, kw, producer in (("in-process", dict(native_preprocess=False), "python"),
                               (f"{GRAIN_WORKERS} workers", dict(
                                   native_preprocess=False, num_workers=GRAIN_WORKERS),
                                "python"),
                               ("native hybrid", dict(native_sibling=str(k3mr)), "native")):
        ld = loader(**kw)
        if ld.producer != producer:
            raise AssertionError(f"grain (b) {what}: the {ld.producer} producer ran "
                                 f"({ld.native_error})")
        runs[what] = _grain_producer(ld, what, card)
    want = runs["in-process"][0]
    for what, (batches, _) in runs.items():
        for i, (a, b) in enumerate(zip(batches, want)):
            _same_batch(a, b, f"grain (b) {what} batch {i}")
    log(f"grain (b): the first {GRAIN_BATCHES} batches of {TRAIN_BATCH} of every producer "
        f"byte for byte equal | {card}")
    out["producers"] = {k: r for k, (_, r) in runs.items()}
    seconds["b"] = time.perf_counter() - t0
    del runs, want

    t0 = time.perf_counter()
    train_dir = WORK / "grain_train"
    with ArrayRecordWriter(str(train_dir / "train_feat.array_record")) as w:
        for i in range(PACKED_STEPS * TRAIN_BATCH):
            w.write_payload(reader.payload(i))
    reader.close()
    argv = _pretrain_argv(train_dir, WORK / "grain_out", "--file_name",
                          "{}_feat.array_record", "--data_backend", "grain",
                          "--num_workers", str(GRAIN_WORKERS))
    run = _flag_run(card, "grain (c) pretrain --data_backend grain", pretrain.main, argv,
                    cfg, lambda steps: expected_train_launches(cfg, steps), "samples",
                    lambda trainer: trainer.stage(next(iter(_pretrain_loader(
                        k3mr, cfg, TRAIN_BATCH)))), producer="python")
    if run["loader"] != "GrainPretrainLoader":
        raise AssertionError(f"grain (c): the CLI trained from {run['loader']}")
    out["pretrain"] = run
    ref = train_res["step_ms"]
    log(f"grain (c): --data_backend grain, {GRAIN_WORKERS} workers: {run['samples_per_s']:.2f} "
        f"samples/s, step ms mean {sum(run['step_ms']) / len(run['step_ms']):.2f} "
        f"({PACKED_STEPS} steps); phase 6 (k3mr, native producer, {TRAIN_STEPS} steps) "
        f"{train_res['samples_per_s']:.2f} samples/s, step ms mean "
        f"{sum(ref) / len(ref):.2f}, the same call: a reading, not a claim | {card}")
    shutil.rmtree(WORK / "grain_out", ignore_errors=True)
    shutil.rmtree(train_dir, ignore_errors=True)
    shutil.rmtree(data_dir, ignore_errors=True)
    seconds["c"] = time.perf_counter() - t0
    out["part_seconds"] = seconds
    log(f"grain: part seconds { {k: round(v, 1) for k, v in seconds.items()} }")
    return out


# ------------------------------------- the LN forward on the main paths (--ln-paths)

LN_PATHS_RUN = """
import json, shutil, sys
sys.path.insert(0, '.')
import chip_smoke as c
card = c.phase_env()
c.phase_build()
c.phase_native_build(card)
if c.WORK.exists():
    shutil.rmtree(c.WORK)
res = dict(slice=c.phase_slice(card, profile=True), train=c.phase_train(card),
           finetune=c.phase_finetune(card), host_us=c.launch_overhead(card))
print('LN_PATHS ' + json.dumps(res, default=str), flush=True)
"""


def ln_path_readings(res):
    """What the LN forward moves in phases 4 (profiled), 6 and 8: its device
    ms and kernels in the profiled serving forward and train steps, their
    busy ms, the device forward ms, the step rates, and the host us per
    call of the tree's LN wrapper and of F.layer_norm."""
    out = {}
    for name, key in (("serving forward", "slice"), ("pretraining step", "train"),
                      ("finetune step", "finetune")):
        prof = res[key]["profile"]
        out[name] = dict(ln_fwd_ms=prof["device_ms_by_class"].get("fused_layernorm", 0.0),
                         ln_fwd_kernels=prof["launches_by_class"].get("fused_layernorm", 0),
                         busy_ms=prof["busy_ms"])
    out["serving forward"]["forward_ms"] = res["slice"]["forward_ms"]
    out["pretraining step"]["samples_per_s"] = res["train"]["samples_per_s"]
    out["finetune step"]["pairs_per_s"] = res["finetune"]["pairs_per_s"]
    out["host_us_per_call"] = res["host_us"]
    return out


def _ln_paths_run(tree, card):
    """LN_PATHS_RUN in a process of its own from the root of `tree`; its log
    goes to chiprun_out/ln_paths_<n>.log."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", LN_PATHS_RUN], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    n = len(list(OUT_JSON.parent.glob("ln_paths_*.log")))
    (OUT_JSON.parent / f"ln_paths_{n}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"phases 4, 6, 8 of {tree} failed ({proc.returncode}): "
                             f"{proc.stderr[-2000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("LN_PATHS "))
    res = ln_path_readings(json.loads(line[len("LN_PATHS "):]))
    log(f"ln paths: {tree} in {time.perf_counter() - t0:.1f} s: {res} | {card}")
    return res


def phase_ln_paths(card):
    """--ln-paths: phases 4 (profiled), 6 and 8, each run in a process of its
    own and reduced by ln_path_readings: with --parent DIR, DIR's
    chip_smoke.py and this tree's in turns (parent, this tree, this tree,
    parent, parent, this tree), else this tree's once."""
    trees = [ROOT] if PARENT_DIR is None else [PARENT_DIR, ROOT, ROOT, PARENT_DIR,
                                                PARENT_DIR, ROOT]
    runs = [dict(tree="this tree" if Path(t).resolve() == ROOT else "parent",
                 **_ln_paths_run(Path(t).resolve(), card)) for t in trees]
    return runs


SUMMARY = {
    # name: (source, TPU kernel, heaviest main-path row: shape part, dtype, rate)
    "fused_layernorm": ("k3m_tpu_torch/kernels/csrc/layernorm.cu",
                        "k3m_tpu/kernels/layernorm.py:37", "pv", "bfloat16->bfloat16", None),
    "layernorm_bwd": ("k3m_tpu_torch/kernels/csrc/layernorm.cu",
                      "k3m_tpu/kernels/layernorm.py:51", "pv", "bfloat16", None),
    "fused_attention": ("k3m_tpu_torch/kernels/csrc/attention.cu",
                        "k3m_tpu/kernels/attention.py:29", "L256", "bfloat16", 0.1),
    "attention_bwd": ("k3m_tpu_torch/kernels/csrc/attention_bwd.cu",
                      "k3m_tpu/kernels/attention.py:63", "L256 D64", "bfloat16", 0.1),
    "fused_biattention": ("k3m_tpu_torch/kernels/csrc/coattn.cu",
                          "k3m_tpu/kernels/coattn.py:28", "L37<->256", "bfloat16", 0.1),
}


def _row(krows, name, shape, dtype, rate, batch):
    return next((r for r in krows if r["kernel"] == name and shape in r["shape"]
                 and r["batch"] == batch and r["dtype"] == dtype
                 and r.get("residual", True) and (rate is None or r.get("rate") == rate)),
                None)


LEGACY_SUMMARY = {
    # name: the heaviest row at the legacy CLI's default shapes: shape part, dtype, rate
    "fused_layernorm": ("pv128", "bfloat16->bfloat16", None),
    "layernorm_bwd": ("pv128", "bfloat16", None),
    "fused_attention": ("L128", "bfloat16", 0.1),
    "attention_bwd": ("L128 D64", "bfloat16", 0.1),
    "fused_biattention": ("L37<->128", "bfloat16", 0.1),
}


TP_SUMMARY = {
    # name: the heaviest TP row of M model ranks: shape part, dtype, rate
    "fused_attention": ("L256 D64 pv tp{M}", "bfloat16", 0.1),
    "attention_bwd": ("L256 D64 pv tp{M}", "bfloat16", 0.1),
    "fused_biattention": ("L37<->256 D128 c_layer_pv_v tp{M}", "bfloat16", 0.1),
}


PACKED_SUMMARY = {
    # name: the packed_passes / fused_qkv rows (bf16, rate 0.1); #5 has none
    "fused_layernorm": ("packed text", "bfloat16->bfloat16", None),
    "layernorm_bwd": ("packed text", "bfloat16", None),
    "fused_attention": ("pv packed+fused", "bfloat16", 0.1),
    "attention_bwd": ("pv packed+fused", "bfloat16", 0.1),
}


OPTION_SUMMARY = {
    # name: the new shapes of the trunk options' rows (bf16, rate 0.1)
    "fused_layernorm": ("pv+task", "bfloat16->bfloat16", None),
    "layernorm_bwd": ("pv+task", "bfloat16", None),
    "fused_attention": ("L257", "bfloat16", 0.1),
    "attention_bwd": ("L257 D64", "bfloat16", 0.1),
    "fused_biattention": ("L37<->257", "bfloat16", 0.1),
}


# the LN forward's rows also time the parent's kernel (--parent) and the
# two-call F.layer_norm(x + r)
LN_TIMES = ("parent_ms", "two_call_library_ms", "l2_copies")


def summarize(krows, paths, legacy, tp_rows, option_rows, packed_rows):
    """One entry per kernel: the row of its heaviest main-path shape (the
    pretraining batch), `launches` from the pretraining run, the launches
    of every path's run (serving, pretraining, finetune, phases 11-14, each
    rank of phases 17 and 19, the extractions of phases 15 and 20, which
    run none of them, the legacy CLI's runs of phase 21, each rank of the
    three CLIs of phase 23), where phase 3 has one, the row of the same
    shape at the finetune batch, the row of phase 21 at the legacy CLI's
    default shapes with that CLI's launches a step, for the attention
    kernels the rows at the head counts of 2 and 4 model ranks, and for #1-#4
    the row at the packed_passes / fused_qkv shapes."""
    summary = []
    for name, (src, replaces, shape, dtype, rate) in SUMMARY.items():
        row = _row(krows, name, shape, dtype, rate, TRAIN_BATCH)
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=paths["pretrain"]["launches"][name],
                     launches_by_path={p: r["launches"][name] for p, r in paths.items()},
                     max_abs_err=row["max_abs_err"], ms=row["ms"],
                     plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=row["bound_by"], library_ms=row["library_ms"],
                     shape=row["shape"], dtype=row["dtype"], rate=row.get("rate"))
        keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        entry.update({k: row[k] for k in LN_TIMES if k in row})
        ft = _row(krows, name, shape, dtype, rate, FT_BATCH)
        if ft is not None:
            entry["finetune_row"] = {k: ft[k] for k in keys}
        lg = _row(legacy["kernel_rows"], name, *LEGACY_SUMMARY[name], TRAIN_BATCH)
        entry["legacy_row"] = dict({k: lg[k] for k in keys},
                                   launches_per_step=legacy["per_step"][name])
        op = _row(option_rows, name, *OPTION_SUMMARY[name], TRAIN_BATCH)
        entry["option_row"] = {k: op[k] for k in keys}
        if name in PACKED_SUMMARY:
            pk = _row(packed_rows, name, *PACKED_SUMMARY[name], TRAIN_BATCH)
            entry["packed_row"] = {k: pk[k] for k in keys}
        if name in TP_SUMMARY:
            part, dt, rt = TP_SUMMARY[name]
            entry["tp_rows"] = {f"n_model {M}": {k: r[k] for k in keys} for M in TP_MS
                                for r in [_row(tp_rows, name, part.format(M=M), dt, rt,
                                               TRAIN_BATCH)]}
        summary.append(entry)
    return summary


def main(argv):
    # the cuBLAS workspace that torch.use_deterministic_algorithms asks for
    # (phase 11); set before the first cuBLAS call of the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if argv[:1] == ["--dp-worker"]:       # one rank of phases 17-19
        return dp_worker(argv[1])
    global PARENT_DIR
    if "--parent" in argv:
        i = argv.index("--parent")
        PARENT_DIR = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if argv[:1] == ["--ln-paths"]:         # phases 4, 6, 8 for the LN forward, alone
        card = phase_env()
        runs = phase_ln_paths(card)
        OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
        (OUT_JSON.parent / "ln_paths.json").write_text(json.dumps(
            {"card": card, "ln_paths": runs}, indent=1, default=float))
        return 0
    if argv[:1] == ["--moe-kernels"]:      # phase 3's MoE part, alone
        card = phase_env()
        build_s, _ = phase_build()
        res = moe_kernel_rows(card)
        OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
        (OUT_JSON.parent / "moe_kernels.json").write_text(json.dumps(
            {"card": card, "build_s": build_s, **res}, indent=1, default=float))
        print(card, flush=True)
        print(json.dumps({"moe_kernels": res["summary"]}), flush=True)
        return 0
    if argv[:1] in (["--dp-cards"], ["--tp-cards"]):   # on N cards, alone
        card = phase_env()
        run_build = phase_build()
        name = argv[0][2:].replace("-", "_")
        res = (phase_dp_cards if name == "dp_cards" else phase_tp_cards)(card, int(argv[1]))
        OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
        (OUT_JSON.parent / f"{name}.json").write_text(json.dumps(
            {"card": card, "build_s": run_build[0], name: res}, indent=1, default=float))
        return 0
    kernels_only = "--kernels-only" in argv
    card = phase_env()
    seconds = {}

    def run(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        log(f"{name}: phase took {seconds[name]:.1f} s")
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # g++ builds the native producer while nvcc builds the kernels
        native_build = None if kernels_only else pool.submit(phase_native_build, card)
        build_s, ptxas = run("build", phase_build)
        native_built = native_build.result() if native_build else None
    k = run("kernels", phase_kernels, card)
    krows, tp_rows, option_rows, packed_rows = (k["rows"], k["tp_rows"], k["option_rows"],
                                                k["packed_rows"])
    kernel_json = dict(kernels=krows, tp_kernels=tp_rows, option_kernels=option_rows,
                       packed_kernels=packed_rows, dropout_masks=k["masks"],
                       forward_edges=k["edges"], ln_edges=k["ln_edges"],
                       host_us_per_call=k["host_us"], moe_kernels=k["moe"],
                       kernel_part_seconds=k["part_seconds"])
    if kernels_only:                   # quick check of a kernel change
        OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
        OUT_JSON.write_text(json.dumps(dict(card=card, build_s=build_s, ptxas=ptxas,
                                            **kernel_json), indent=1))
        print(json.dumps({"moe_kernels": k["moe"]["summary"]}), flush=True)
        return 0
    profile = "--profile" in argv
    if WORK.exists():
        shutil.rmtree(WORK)
    slice_res = run("slice", phase_slice, card, profile=profile)
    cross = run("crosscheck", phase_crosscheck, card)
    train_res = run("train", phase_train, card)
    train_cross = run("train crosscheck", phase_train_crosscheck, card)
    ft_res = run("finetune", phase_finetune, card)
    ft_cross = run("finetune crosscheck", phase_finetune_crosscheck, card)
    native = dict(build=native_built, **run("native", phase_native, card))
    resume = run("resume", phase_resume, card)
    chain = run("chain", phase_chain, card)
    wire = run("wire", phase_wire, card)
    cache = run("cache", phase_cache, card)
    extract = run("extract", phase_extract, card)
    extract_cross = run("extract crosscheck", phase_extract_crosscheck, card)
    dp_train = run("dp_train", phase_dp_train, card)
    dp_cross = run("dp_crosscheck", phase_dp_crosscheck, card)
    dp_predict = run("dp_predict", phase_dp_predict, card)
    legacy_extract = run("legacy_extract", phase_legacy_extract, card)
    legacy = run("legacy_train", phase_legacy_train, card)
    nested = {}

    def trunk_options():               # phase 24, while phase 22's ranks run
        t0 = time.perf_counter()
        nested["result"] = phase_trunk_options(card)
        nested["trunk_options (within tp_crosscheck)"] = time.perf_counter() - t0
        log(f"trunk_options: phase took {nested['trunk_options (within tp_crosscheck)']:.1f} "
            "s, while tp_crosscheck's ranks ran")
    tp_cross = run("tp_crosscheck", phase_tp_crosscheck, card, during=trunk_options)
    options = nested.pop("result")
    tp_train = run("tp_train", phase_tp_train, card)
    packed = run("packed", phase_packed, card, train_res)
    grain = run("grain", phase_grain, card, train_res)
    dp_paths = {f"dp_train_{k}": dict(launches=v) for k, v in dp_train["launches"].items()}
    dp_paths.update({f"dp_predict_{k}": dict(launches=v)
                     for k, v in dp_predict["launches"].items()})
    dp_paths.update({f"tp_{cli}_{k}": dict(launches=v)
                     for cli in ("pretrain", "finetune", "train_concap_struc")
                     for k, v in tp_train[f"{cli}_launches"].items()})
    dp_paths.update({f"packed_pretrain_{k}": dict(launches=v["launches"])
                     for k, v in packed["pretrain"].items() if k != "off"})
    dp_paths["packed_finetune"] = dict(launches=packed["finetune"]["launches"])
    dp_paths["grain_pretrain"] = dict(launches=grain["pretrain"]["launches"])
    summary = summarize(krows, dict(serve=slice_res, pretrain=train_res, finetune=ft_res,
                                    resume=resume, chain=chain, wire=wire, cache=cache,
                                    extract=extract, **dp_paths, legacy_extract=legacy_extract,
                                    legacy_readme=legacy["readme"],
                                    legacy_defaults=legacy["defaults"],
                                    legacy_raw=legacy["raw"]), legacy, tp_rows,
                        option_rows, packed_rows) + k["moe"]["summary"]
    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    OUT_JSON.write_text(json.dumps(dict(card=card, build_s=build_s, ptxas=ptxas,
                                        **kernel_json, slice=slice_res, crosscheck_worst=cross,
                                        train=train_res, train_crosscheck=train_cross,
                                        finetune=ft_res, finetune_crosscheck=ft_cross,
                                        native=native, resume=resume, chain=chain, wire=wire,
                                        cache=cache, extract=extract,
                                        extract_crosscheck=extract_cross,
                                        dp_train=dp_train, dp_crosscheck=dp_cross,
                                        dp_predict=dp_predict, legacy_extract=legacy_extract,
                                        legacy_train=legacy, tp_crosscheck=tp_cross,
                                        tp_train=tp_train, trunk_options=options,
                                        packed=packed, grain=grain,
                                        phase_seconds=seconds,
                                        nested_phase_seconds=nested,
                                        summary=summary), indent=1, default=float))
    log(f"phase seconds {({k: round(v, 1) for k, v in seconds.items()})}, "
        f"{sum(seconds.values()):.1f} s in all; within them "
        f"{({k: round(v, 1) for k, v in nested.items()})}")
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
