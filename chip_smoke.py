#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`k3m_tpu_torch`).

    python3 chip_smoke.py                  # every phase, one CUDA card
    python3 chip_smoke.py --kernels-only   # phases 1-3 only, no result line
    python3 chip_smoke.py --profile        # also trace a bf16 forward and a train step

Phases, in order; any failure exits non-zero and no phase carries on past
a failure:
  1. environment: torch/CUDA versions, card name and power limit;
  2. build: compile the CUDA kernels from k3m_tpu_torch/kernels/csrc/;
  3. kernels: hold each kernel against its plain PyTorch version on the
     card, in fp32 and bf16, at every main-path shape (forward kernels at
     the serving batch 64 and the train batch 96, backward kernels at 96),
     forward kernels at dropout 0 and 0.1, backward kernels at 0 and 0.1
     under the plain version's Philox mask, each (batch, head) of a
     gradient within a share of its own scale, and show that this
     tolerance rejects planted faults; read the forward kernels' dropout masks
     back and hold them to `philox_keep_mask_plain` bit for bit, and their
     keep rate to 0.9 within 4 sigma; time the kernel, the plain version
     and (where one PyTorch call computes the same function) the library
     call; then the host's cost of one wrapper call;
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
     peak memory and the epoch checkpoint's write (with --profile, device
     time by kernel class of one train step);
  7. train cross-check: one fp32 train step at batch 2, dropout off,
     injected LPM negatives and Gumbel noise, on the card (kernels) and on
     the CPU (plain versions): the four losses and every parameter's
     gradient;
  8. print the kernel summary line and the final device line.

Exits non-zero without a result when CUDA is not available. Writes its
data under build/chip_smoke/ and its detailed results to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import re
import shutil
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
N_PAIRS = 256
SEED = 1234
SHAPES = dict(max_seq_length=50, max_seq_length_pv=256, max_num_pv=30,
              max_region_length=36)
RATES = (0.0, 0.1)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ timing

def graph_ms(fn, iters=20):
    """Device ms per call of `fn`: `iters` calls captured in one CUDA graph
    and replayed, so that the host's cost of a call (measured apart, in
    launch_overhead) does not stand in for the time of a small kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                 # warm-up outside the graph
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


def phase_build():
    from k3m_tpu_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build(verbose=True)
    build.library()
    secs = time.perf_counter() - t0
    log(f"build: {path} in {secs:.2f} s")
    ptxas = path.parent / "ptxas.log"
    if ptxas.exists():
        OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ptxas, OUT_JSON.parent / "ptxas.log")
    return secs


def ln_shapes(batch):
    return ((batch * 50, 768, "title"), (batch * 256, 768, "pv"), (batch * 37, 1024, "image"))


FWD_BATCHES = (BATCH, TRAIN_BATCH)     # the forward kernels run on both main paths


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


def kernel_phase_layernorm(card, rows_out):
    import torch.nn.functional as F

    from k3m_tpu_torch.kernels import fused_layernorm, layernorm_plain
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    for batch, (rows, n, what) in ((b, s) for b in FWD_BATCHES for s in ln_shapes(b)):
        for with_res in (False, True):
            for xd, od in ((f32, f32), (bf16, bf16), (f32, bf16)):
                x = (torch.randn(rows, n, generator=g, device="cuda") * 2 + 1).to(xd)
                res = torch.randn(rows, n, generator=g, device="cuda").to(xd) \
                    if with_res else None
                scale = torch.randn(n, generator=g, device="cuda")
                bias = torch.randn(n, generator=g, device="cuda")
                out = fused_layernorm(x, scale, bias, res, out_dtype=od)
                ref = layernorm_plain(x, scale, bias, res, out_dtype=od)
                torch.cuda.synchronize()
                lib = None
                if res is None and xd == od:
                    sx, bx = scale.to(xd), bias.to(xd)
                    lib = graph_ms(lambda: F.layer_norm(x, (n,), sx, bx, 1e-12))
                elem = rows * n
                nbytes = elem * (x.element_size() + (res.element_size() if with_res else 0)
                                 + torch.empty(0, dtype=od).element_size()) + 2 * n * 4
                bound, by = _bound(nbytes, elem * (8 if with_res else 7), f32)
                _record(rows_out, card, kernel="fused_layernorm", shape=f"[{rows},{n}] {what}",
                        batch=batch, residual=with_res,
                        dtype=f"{_dt_name(xd)}->{_dt_name(od)}",
                        max_abs_err=max_err(out, ref), tol=tolerance(ref, od),
                        ms=graph_ms(lambda: fused_layernorm(x, scale, bias, res, out_dtype=od)),
                        plain_ms=graph_ms(lambda: layernorm_plain(x, scale, bias, res,
                                                                  out_dtype=od)),
                        library_ms=lib, bound_ms=bound, bound_by=by)


def kernel_phase_layernorm_bwd(card, rows_out):
    """The backward kernel on the output and rstd of the forward kernel, as
    the training path calls it. dx within the forward's share of its scale;
    dscale/dbias (fp32 sums over all rows, in another order) within 1e-4 of
    theirs. Library: aten's native_layer_norm_backward on the same input."""
    from k3m_tpu_torch.kernels import layernorm_bwd, layernorm_bwd_plain
    from k3m_tpu_torch.kernels.layernorm import _forward
    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(3)
    for rows, n, what in ln_shapes(TRAIN_BATCH):
        for with_res in (False, True):
            for dt in (f32, torch.bfloat16):
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
                if what == "pv" and not with_res:
                    _same_twice("layernorm_bwd", f"[{rows},{n}] {_dt_name(dt)}", got,
                                lambda: layernorm_bwd(y, rstd, scale, bias, dy, dt), card)
                esz = y.element_size()
                bound, by = _bound(3 * rows * n * esz + 4 * rows + 16 * n, 16 * rows * n, f32)
                _record(rows_out, card, kernel="layernorm_bwd", shape=f"[{rows},{n}] {what}",
                        batch=TRAIN_BATCH, residual=with_res, dtype=_dt_name(dt),
                        max_abs_err=err, tol=tol,
                        ms=graph_ms(lambda: layernorm_bwd(y, rstd, scale, bias, dy, dt)),
                        plain_ms=graph_ms(lambda: layernorm_bwd_plain(y, rstd, scale, bias,
                                                                      dy, dt)),
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
    return max(graph_ms(fwd_bwd, iters=10) - graph_ms(fwd, iters=10), 0.0)


ATTN_SHAPES = ((12, 50, 64, "title"), (12, 256, 64, "pv"), (8, 37, 128, "image"))
BIATTN_SHAPES = ((37, 50, 128, "c_layer"), (37, 256, 128, "c_layer_pv_v"),
                 (256, 50, 96, "c_layer_pv_t"))


def kernel_phase_attention(card, rows_out):
    from k3m_tpu_torch.kernels import attention_plain, fused_attention, philox_keep_mask_plain
    from k3m_tpu_torch.kernels.attention import _forward
    g = torch.Generator(device="cuda").manual_seed(1)
    for B, (H, L, D, what) in ((b, s) for b in FWD_BATCHES for s in ATTN_SHAPES):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(B, L, H, D, dt, g)
            bias = _ragged_bias(B, L, g)
            for rate in RATES:
                seed = 11
                keep = philox_keep_mask_plain(seed, B, H, L, L, rate, 0, "cuda") if rate else None
                out = fused_attention(q, k, v, bias, dropout_rate=rate, seed=seed)
                ref = attention_plain(q, k, v, bias, keep, rate)
                out_l, lse, words = _forward(q, k, v, bias, rate, seed, for_backward=True)
                torch.cuda.synchronize()
                if not torch.equal(out, out_l):
                    raise AssertionError(f"fused_attention {what}: keeping lse and the mask "
                                         "changed the output")
                tag = f"B{B} L{L} D{D} {_dt_name(dt)} rate {rate}"
                lse_ratio = _check_lse("fused_attention", tag, lse, q, k, bias, card)
                if words is not None:
                    _check_words("fused_attention", tag, words, keep, card)
                bound, by = _bound(4 * B * L * H * D * q.element_size() + B * L * 4,
                                   _attn_ops(B, H, L, L, D), dt)
                # timed as its path calls it: training (B96) keeps lse and the
                # mask words for the backward, serving (B64) keeps nothing
                train = B == TRAIN_BATCH
                _record(rows_out, card, kernel="fused_attention", batch=B,
                        shape=f"B{B} H{H} L{L} D{D} {what}", dtype=_dt_name(dt), rate=rate,
                        max_abs_err=max_err(out, ref), tol=tolerance(ref, dt),
                        ms=graph_ms(lambda: _forward(q, k, v, bias, rate, seed,
                                                     for_backward=train)),
                        timed_for_backward=train,
                        plain_ms=graph_ms(lambda: attention_plain(q, k, v, bias, keep, rate)),
                        library_ms=graph_ms(lambda: _sdpa(q, k, v, bias, rate)),
                        bound_ms=bound, bound_by=by, lse_err_ratio=lse_ratio)


def kernel_phase_biattention(card, rows_out):
    from k3m_tpu_torch.kernels import biattention_plain, fused_biattention, \
        philox_keep_mask_plain
    from k3m_tpu_torch.kernels.coattn import _forward
    g = torch.Generator(device="cuda").manual_seed(2)
    H = 8
    for B, (L1, L2, D, what) in ((b, s) for b in FWD_BATCHES for s in BIATTN_SHAPES):
        for dt in (torch.float32, torch.bfloat16):
            q1, k1, v1 = _qkv(B, L1, H, D, dt, g)
            q2, k2, v2 = _qkv(B, L2, H, D, dt, g)
            b1, b2 = _ragged_bias(B, L1, g), _ragged_bias(B, L2, g)
            args = (q1, k1, v1, b1, q2, k2, v2, b2)
            for rate in RATES:
                seed = 13
                m1 = philox_keep_mask_plain(seed, B, H, L2, L1, rate, 0, "cuda") if rate else None
                m2 = philox_keep_mask_plain(seed, B, H, L1, L2, rate, 7919, "cuda") \
                    if rate else None
                drop = dict(dropout1=rate, dropout2=rate, seed=seed)
                c1, c2 = fused_biattention(*args, **drop)
                r1, r2 = biattention_plain(*args, m1, m2, rate, rate)
                l_c1, l_c2, (lse1, w1), (lse2, w2) = _forward(*args, rate, rate, seed,
                                                              for_backward=True)
                torch.cuda.synchronize()
                if not (torch.equal(c1, l_c1) and torch.equal(c2, l_c2)):
                    raise AssertionError(f"fused_biattention {what}: keeping lse and the mask "
                                         "changed the output")
                tag = f"B{B} L{L1}<->{L2} D{D} {_dt_name(dt)} rate {rate}"
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
                train = B == TRAIN_BATCH      # timed as its path calls it
                _record(rows_out, card, kernel="fused_biattention", batch=B,
                        shape=f"B{B} H{H} L{L1}<->{L2} D{D} {what}", dtype=_dt_name(dt),
                        rate=rate, max_abs_err=max(max_err(c1, r1), max_err(c2, r2)),
                        tol=min(tolerance(r1, dt), tolerance(r2, dt)),
                        ms=graph_ms(lambda: _forward(*args, rate, rate, seed,
                                                     for_backward=train)),
                        timed_for_backward=train,
                        plain_ms=graph_ms(lambda: biattention_plain(*args, m1, m2, rate, rate)),
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


BWD_TILE = 64      # keys per CTA of the bf16 dK/dV kernel (attention_mma.cuh kMmaBQ)


def _forward_kept(ops_, rate, seed):
    """What the forward kernel keeps for the backward of each direction of
    `ops_`, as the training path saves it: (output, lse, keep words or
    None); the self-attention kernel for one direction, the bi-attention
    kernel for two."""
    from k3m_tpu_torch.kernels import attention, coattn
    if len(ops_) == 1:
        q, k, v, b = ops_[0][:4]
        return [attention._forward(q, k, v, b, rate, seed, for_backward=True)]
    (q2, k1, v1, b1), (q1, k2, v2, b2) = (o[:4] for o in ops_)
    c1, c2, kept1, kept2 = coattn._forward(q1, k1, v1, b1, q2, k2, v2, b2, rate, rate,
                                           seed, for_backward=True)
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
    for (q, k, v, b, do, salt, H, Lq, Lk, D), (out, lse, _), (_, _, other), (dq, dk, dv) \
            in zip(ops_, fwd, wrong, got):
        keep = philox_keep_mask_plain(seed, q.shape[0], H, Lq, Lk, rate, salt, "cuda")
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
    for i, (q, k, v, b, do, salt, H, Lq, Lk, D) in enumerate(ops_):
        e = q.element_size()
        total += 3 * q.shape[0] * Lq * H * D * e + 4 * q.shape[0] * Lk * H * D * e \
            + q.shape[0] * Lk * 4
        if fwd is not None:
            total += sum(t.numel() * t.element_size() for t in fwd[i] if t is not None)
    return total


def kernel_phase_attention_bwd(card, rows_out):
    """The backward kernel for each self-attention shape and, once per
    direction, each co-attention shape, at rate 0 and 0.1 (under the plain
    version's Philox mask), at the train batch, fed the forward kernel's
    output and lse as the training path feeds it; at rate 0.1 the tolerance
    must also reject the planted faults, and at the heaviest shape two calls
    must give the same bits. The backward reads what the forward kernel
    keeps for it (output, lse, mask words), as on the training path;
    times are of the backward alone."""
    from k3m_tpu_torch.kernels import attention_bwd, attention_bwd_plain, \
        philox_keep_mask_plain
    g = torch.Generator(device="cuda").manual_seed(4)
    B = TRAIN_BATCH
    cases = [(f"B{B} H{H} L{L} D{D} {what}", [(H, L, L, D, 0)])
             for H, L, D, what in ATTN_SHAPES]
    cases += [(f"B{B} H8 L{L1}<->{L2} D{D} {what}", [(8, L2, L1, D, 0), (8, L1, L2, D, 7919)])
              for L1, L2, D, what in BIATTN_SHAPES]
    for shape, dirs in cases:
        for dt in (torch.float32, torch.bfloat16):
            ops_ = []
            for H, Lq, Lk, D, salt in dirs:
                q = _qkv(B, Lq, H, D, dt, g)[0]
                k, v = _qkv(B, Lk, H, D, dt, g)[1:]
                do = torch.randn(B, Lq, H, D, generator=g, device="cuda").to(dt)
                ops_.append((q, k, v, _ragged_bias(B, Lk, g), do, salt, H, Lq, Lk, D))
            for rate in RATES:
                seed = 17
                fwd = _forward_kept(ops_, rate, seed)
                keeps = [philox_keep_mask_plain(seed, B, H, Lq, Lk, rate, salt, "cuda")
                         if rate else None
                         for q, k, v, b, do, salt, H, Lq, Lk, D in ops_]

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
                ops = sum(5 * 2 * B * H * Lq * Lk * D for *_, H, Lq, Lk, D in ops_)
                bound, by = _bound(_attn_bwd_bytes(ops_, None), ops, dt)
                design_bound, _ = _bound(_attn_bwd_bytes(ops_, fwd), ops, dt)
                if faults:
                    log(f"attention_bwd {shape} {_dt_name(dt)}: planted faults rejected, "
                        f"error/tolerance {faults}")
                _record(rows_out, card, kernel="attention_bwd", shape=shape, batch=B,
                        dtype=_dt_name(dt), rate=rate, directions=len(ops_),
                        max_abs_err=err, tol=tol, planted_faults=faults,
                        ms=graph_ms(kernel), plain_ms=graph_ms(plain),
                        library_ms=_sdpa_bwd_ms([o[:5] for o in ops_], rate),
                        bound_ms=bound, bound_by=by, design_bound_ms=design_bound)
                del fwd, got, want


def dropout_mask_check(card):
    """Read the forward kernels' dropout masks back at main-path shapes and
    hold them to philox_keep_mask_plain bit for bit: with q = k = 0 and v
    the one-hot rows of the identity over a window of D keys (the others
    masked by the bias), output column d of query q is keep(q, k0 + d) / D
    * scale, positive exactly where the kernel kept. Self-attention at the
    pv shape (salt 0) and both directions of c_layer_pv_t (salts 0, 7919),
    bf16 (the tensor-core tile of the main path); then the keep rate of all
    draws against 0.9 within 4 sigma."""
    from k3m_tpu_torch.kernels import fused_attention, fused_biattention, \
        philox_keep_mask_plain
    rate, seed, B = 0.1, 77, TRAIN_BATCH
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
        log(f"dropout mask {name}: {a.numel()} draws, {bad} differ from "
            f"philox_keep_mask_plain | {card}")
        if bad:
            raise AssertionError(f"dropout mask {name}: {bad} bits differ")
        kept += int(a.sum())
        draws += a.numel()
    share = kept / draws
    sigma = math.sqrt(0.9 * 0.1 / draws)
    log(f"dropout keep rate {share:.6f} over {draws} draws; 0.9 +- 4 sigma = "
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


def phase_kernels(card):
    rows = []
    for phase in (kernel_phase_layernorm, kernel_phase_layernorm_bwd,
                  kernel_phase_attention, kernel_phase_biattention,
                  kernel_phase_attention_bwd):
        phase(card, rows)
        torch.cuda.empty_cache()
    masks = dropout_mask_check(card)
    torch.cuda.empty_cache()
    return rows, launch_overhead(card), masks


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


def write_pair_records(path):
    from k3m_tpu_torch.data.records import write_records
    from k3m_tpu_torch.tokenization import build_synthetic_vocab
    rng = np.random.default_rng(SEED)
    vocab = build_synthetic_vocab()
    pairs = (dict(label=float(i % 2), item1=_synthetic_item(rng, vocab, 2 * i),
                  item2=_synthetic_item(rng, vocab, 2 * i + 1))
             for i in range(N_PAIRS))
    return write_records(str(path), pairs)


def expected_launches(cfg, n_item_forwards):
    """Kernel launches of one item forward of K3MForItemAlignment, times the
    number of item forwards (no shared_prefix, image and co-attention on):
    3 embedding LNs; every text layer runs 4 times (t and pv in passes
    t<->v, pv<->v, and both streams of t<->pv), every image layer twice;
    2 LNs + 1 attention per layer, 4 LNs + 1 bi-attention per connection
    layer (3 stacks)."""
    text, image, conn = 4 * cfg.num_hidden_layers, 2 * cfg.v_num_hidden_layers, \
        3 * cfg.num_coattention_layers
    return dict(fused_layernorm=n_item_forwards * (3 + 2 * (text + image) + 4 * conn),
                fused_attention=n_item_forwards * (text + image),
                fused_biattention=n_item_forwards * conn)


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
                **device)


def _loader(path, cfg, batch_size):
    from k3m_tpu_torch.data.pipeline import AlignmentLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.tokenization import get_tokenizer
    shapes = ShapeSpec(max_seq_len=SHAPES["max_seq_length"],
                       max_seq_len_pv=SHAPES["max_seq_length_pv"],
                       max_num_pv=SHAPES["max_num_pv"],
                       max_region_len=SHAPES["max_region_length"])
    return AlignmentLoader(str(path), get_tokenizer(None, cfg.vocab_size), shapes,
                           batch_size=batch_size, drop_last=False)


def _load_batch(path, cfg, batch_size):
    return next(iter(_loader(path, cfg, batch_size)))


def loader_rate(cfg, path, card):
    """Seconds per batch of the pair loader alone (read, tokenize,
    preprocess, collate on its producer thread), over the whole file."""
    t0 = time.perf_counter()
    n = sum(1 for _ in _loader(path, cfg, BATCH))
    s_per_batch = (time.perf_counter() - t0) / n
    log(f"slice: loader alone {s_per_batch:.4f} s per batch of {BATCH} pairs "
        f"over {n} batches (host) | {card}")
    return s_per_batch


def _model(cfg, device):
    from k3m_tpu_torch.model.alignment import build_model
    return build_model(cfg, seed=SEED, device=device)


def _kernel_class(name):
    for key, cls in (("biattn_fwd", "fused_biattention"),
                     ("attn_fwd", "fused_attention"),
                     ("attn_bwd", "attention_bwd"),
                     ("ln_fwd_kernel", "fused_layernorm"),
                     ("ln_bwd", "layernorm_bwd")):
        if key in name:
            return cls
    low = name.lower()
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


def write_pretrain_records(path, n):
    from k3m_tpu_torch.data.records import write_records
    from k3m_tpu_torch.tokenization import build_synthetic_vocab
    rng = np.random.default_rng(SEED + 1)
    vocab = build_synthetic_vocab()
    return write_records(str(path), (_synthetic_item(rng, vocab, i) for i in range(n)))


def expected_train_launches(cfg, steps):
    """Kernel launches of `steps` train steps of K3MForPretraining (image and
    co-attention on): the forward as one item forward of the serving path
    plus the heads' 3 LNs (the MLM transform for title and pv, the RoI
    transform); every LN and attention has its backward, and each
    bi-attention two (one per direction)."""
    text, image, conn = 4 * cfg.num_hidden_layers, 2 * cfg.v_num_hidden_layers, \
        3 * cfg.num_coattention_layers
    ln = 3 + 2 * (text + image) + 4 * conn + 3
    return dict(fused_layernorm=steps * ln, layernorm_bwd=steps * ln,
                fused_attention=steps * (text + image),
                attention_bwd=steps * (text + image + 2 * conn),
                fused_biattention=steps * conn)


def _pretrain_loader(path, cfg, batch_size):
    from k3m_tpu_torch.data.pipeline import PretrainLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.tokenization import get_tokenizer
    shapes = ShapeSpec(max_seq_len=SHAPES["max_seq_length"],
                       max_seq_len_pv=SHAPES["max_seq_length_pv"],
                       max_num_pv=SHAPES["max_num_pv"],
                       max_region_len=SHAPES["max_region_length"])
    return PretrainLoader(str(path), get_tokenizer(None, cfg.vocab_size), shapes,
                          batch_size=batch_size, shuffle=False, seed=SEED)


def pretrain_loader_rate(cfg, path, card):
    """Seconds per batch of the pretraining loader alone (read, tokenize,
    mask, collate on its producer thread), over the whole file."""
    t0 = time.perf_counter()
    n = sum(1 for _ in _pretrain_loader(path, cfg, TRAIN_BATCH))
    s_per_batch = (time.perf_counter() - t0) / n
    log(f"train: loader alone {s_per_batch:.4f} s per batch of {TRAIN_BATCH} "
        f"over {n} batches (host) | {card}")
    return s_per_batch


def phase_train(card, profile=False):
    from k3m_tpu_torch import kernels, pretrain
    from k3m_tpu_torch.config import K3MConfig

    data_dir, out_dir = WORK / "pretrain_data", WORK / "pretrain_out"
    t0 = time.perf_counter()
    n = write_pretrain_records(data_dir / "train_feat.k3mr", TRAIN_STEPS * TRAIN_BATCH)
    log(f"train: wrote {n} pretraining records in {time.perf_counter() - t0:.1f} s")
    cfg = K3MConfig.from_json_file(str(ROBERTA))
    loader_s = pretrain_loader_rate(cfg, data_dir / "train_feat.k3mr", card)
    argv = ["--data_dir", str(data_dir), "--output_dir", str(out_dir),
            "--file_name", "{}_feat.k3mr", "--bf16", "--use_image",
            "--train_batch_size", str(TRAIN_BATCH), "--num_train_epochs", "1",
            "--seed", str(SEED), "--log_steps", "1"]
    for k, v in SHAPES.items():
        argv += [f"--{k}", str(v)]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = pretrain.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    (hist,) = run["history"]
    steps = len(hist["step_seconds"])
    expected = expected_train_launches(cfg, steps)
    log(f"train: launches {counts} expected {expected}")
    if steps != TRAIN_STEPS:
        raise AssertionError(f"{steps} train steps, expected {TRAIN_STEPS}")
    for name, want in expected.items():
        if counts[name] != want or counts[name] == 0:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")
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
    ckpt = Path(hist["checkpoint_path"]) / "state.pt"
    ckpt_gib = ckpt.stat().st_size / 2 ** 30
    log(f"train: epoch checkpoint {ckpt_gib:.2f} GiB written in "
        f"{hist['checkpoint_seconds']:.2f} s (torch.save of model, AdamW and step; "
        f"outside step ms) | {card}")
    res = dict(launches=counts, expected=expected, samples_per_s=samples_per_s,
               step_ms=step_ms, first_step_ms=1e3 * hist["step_seconds"][0],
               peak_gib=peak, loader_s_per_batch=loader_s,
               checkpoint_s=hist["checkpoint_seconds"], checkpoint_gib=ckpt_gib,
               step_losses=hist["step_losses"])
    if profile:
        trainer = run["trainer"]
        batch = trainer.stage(next(iter(_pretrain_loader(
            data_dir / "train_feat.k3mr", cfg, TRAIN_BATCH))))
        res["profile"] = profile_device(lambda: trainer.train_step(batch), card,
                                        f"bf16 train step of {TRAIN_BATCH}", n=1)
    del run
    torch.cuda.empty_cache()
    return res


def phase_train_crosscheck(card):
    """One fp32 train step (losses and backward) at batch 2 on the card
    (kernels) and on the CPU (plain versions), same seeded weights, dropout
    off, injected LPM negatives and Gumbel noise. The noise puts its
    one-hot pick 4 above the other options, so 1e-6 differences cannot flip
    a hard selection (that would test the argmax, not the kernels).
    Tolerances: losses 1e-4 of their scale; each gradient tensor 1e-3 of
    its largest magnitude plus 1e-7 (fp32 on both sides, but a full-width
    backward through ~300 layer applications, sums in another order, and
    gradients that are zero in exact arithmetic)."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    cfg = K3MConfig.from_json_file(str(ROBERTA)).replace(use_image=True, objective=2)
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
        log(f"train crosscheck {k}: card {l_gpu[k]:.6f} cpu {l_cpu[k]:.6f} (tol {tol:.1e})")
        if not (math.isfinite(l_gpu[k]) and err <= tol):
            raise AssertionError(f"train crosscheck {k}: {err} > {tol}")
    if set(g_cpu) != set(g_gpu) or not g_cpu:
        raise AssertionError("train crosscheck: the two devices gave different gradients")
    worst, worst_name = 0.0, None
    for name, a in g_cpu.items():
        tol = 1e-3 * float(a.abs().max()) + 1e-7
        ratio = max_err(g_gpu[name], a) / tol
        if ratio > worst:
            worst, worst_name = ratio, name
        if not (torch.isfinite(g_gpu[name]).all() and ratio <= 1.0):
            raise AssertionError(f"train crosscheck gradient {name}: "
                                 f"{max_err(g_gpu[name], a)} > {tol}")
    log(f"train crosscheck: {len(g_cpu)} gradient tensors agree card vs CPU; worst "
        f"error/tolerance {worst:.3e} ({worst_name}) | {card}")
    return dict(losses_cpu=l_cpu, losses_card=l_gpu, worst_grad_ratio=worst,
                worst_grad=worst_name, n_grads=len(g_cpu))


# ------------------------------------------------------------------ main

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


def summarize(krows, train_res):
    summary = []
    for name, (src, replaces, shape, dtype, rate) in SUMMARY.items():
        row = next(r for r in krows if r["kernel"] == name and shape in r["shape"]
                   and r["batch"] == TRAIN_BATCH
                   and r["dtype"] == dtype and r.get("residual", True)
                   and (rate is None or r.get("rate") == rate))
        summary.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=train_res["launches"][name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"],
                            shape=row["shape"], dtype=row["dtype"],
                            rate=row.get("rate")))
    return summary


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = phase_env()
    build_s = phase_build()
    krows, host_us, masks = phase_kernels(card)
    if "--kernels-only" in argv:       # quick check of a kernel change
        OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
        OUT_JSON.write_text(json.dumps(dict(card=card, build_s=build_s, kernels=krows,
                                            dropout_masks=masks, host_us_per_call=host_us),
                                       indent=1))
        return 0
    profile = "--profile" in argv
    if WORK.exists():
        shutil.rmtree(WORK)
    slice_res = phase_slice(card, profile=profile)
    cross = phase_crosscheck(card)
    train_res = phase_train(card, profile=profile)
    train_cross = phase_train_crosscheck(card)
    summary = summarize(krows, train_res)
    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    OUT_JSON.write_text(json.dumps(dict(card=card, build_s=build_s, kernels=krows,
                                        dropout_masks=masks, host_us_per_call=host_us,
                                        slice=slice_res, crosscheck_worst=cross,
                                        train=train_res, train_crosscheck=train_cross,
                                        summary=summary), indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
