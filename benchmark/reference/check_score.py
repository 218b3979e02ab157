"""`correct` for a scoring cell: a sample of the pairs, drawn from the
seed, as every pass of the window scored them, against the reference's
forward of the same pairs from the same seed (fp32, TF32 off).

Numbers compared (each against its limit from the cell file):
  input_mismatch  elements of a staged batch's sampled rows that disagree
                  with the records (reference/inputs.py); limit 0
  missing         sampled pairs that a pass of the window should have
                  scored and did not answer; limit 0
  emb_l2_gap      the largest L2 gap between an embedding of the program
                  and the reference's, over the reference embedding's L2
                  norm, of any sampled pair, item and pass
The probabilities are not compared: at these logits the sigmoid is 0 or
1 in fp32 for the program, the reference and the control alike, so their
gap reads 0 on all three; nor are the logits (the embeddings' inner
products, `logit_gap`, printed) or the embeddings' largest elementwise
gap (`emb_gap`, printed), which the control reads less than three times
as far from the reference as sound runs do (PERF.md).
"""

from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from benchmark.lib import weights
from benchmark.reference import inputs as ref_inputs


def reference_config(config: dict, control: bool = False):
    """The reference's configuration: float32, or for the control the
    configuration's own dtype (reference/control.py)."""
    from benchmark.reference.k3m_plain.config import K3MConfig
    cfg = K3MConfig.from_dict(config)
    return cfg if control else cfg.replace(dtype="float32")


def sample_pairs(seed: int, n_pairs: int, n_sample: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 7])
    return np.sort(rng.choice(n_pairs, size=min(n_sample, n_pairs), replace=False))


@torch.no_grad()
def reference_scores(config: dict, seed: int, arrays: dict, device, control: bool = False,
                     chunk: int = 32, count_flops: bool = False):
    """(emb1, emb2, probs, FLOPs a pair) of the reference's forward."""
    from benchmark.reference import control as ctl
    from benchmark.reference.k3m_plain import alignment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reference_config(config, control)
    with torch.device(device):
        model = alignment.K3MForItemAlignment(cfg)
    weights.fill_weights(model, seed, cfg.initializer_range)
    model.eval()
    batch = ref_inputs.to_device(arrays, device)
    n = batch["label"].shape[0]
    outs, flops = [], None
    for s in range(0, n, chunk):
        rows = slice(s, s + chunk)
        part = dict(label=batch["label"][rows],
                    item1={k: v[rows] for k, v in batch["item1"].items()},
                    item2={k: v[rows] for k, v in batch["item2"].items()})
        with (ctl.lower_precision() if control else contextlib.nullcontext()):
            if count_flops and s == 0:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as fc:
                    e1, e2, p, _ = model(part["label"], part["item1"], part["item2"],
                                         deterministic=True)
                flops = fc.get_total_flops() / part["label"].shape[0]
            else:
                e1, e2, p, _ = model(part["label"], part["item1"], part["item2"],
                                     deterministic=True)
        outs.append((e1.float().cpu(), e2.float().cpu(), p.float().cpu()))
    del model, batch
    gc.collect()
    e1, e2, p = (torch.cat([o[i] for o in outs]) for i in range(3))
    return e1, e2, p, flops


def all_gaps(got, ref) -> dict:
    """Candidate numbers of one set of answers against the reference's:
    the largest over pairs and items of the max-abs gap over the max-abs
    element, of the L2 gap over the L2 norm, and of the logit's gap over
    the product of the embeddings' norms; and the largest probability gap."""
    sides = ((got[0], ref[0]), (got[1], ref[1]))
    emb = max(float(((g - r).abs().amax(-1) / r.abs().amax(-1).clamp(min=1e-12)).max())
              for g, r in sides)
    prob = float((got[2] - ref[2]).abs().max())
    l2 = max(float(((g - r).norm(dim=-1) / r.norm(dim=-1).clamp(min=1e-12)).max())
             for g, r in sides)
    lg, lr = (got[0] * got[1]).sum(-1), (ref[0] * ref[1]).sum(-1)
    logit = float(((lg - lr).abs() / (ref[0].norm(dim=-1) * ref[1].norm(dim=-1))).max())
    return dict(emb_gap=emb, emb_l2_gap=l2, logit_gap=logit, prob_gap=prob)


def check(run, kept, device) -> None:
    limits = run.spec.cell["limits"]
    traffic = run.spec.traffic
    n_pairs, batch = traffic["records"], traffic["batch_size"]
    sample = sample_pairs(run.seed, n_pairs, run.spec.cell["check_pairs"])
    arrays = ref_inputs.pair_inputs(run.seed, sample, traffic)
    first, rows = kept["staged_first"], kept["staged"]["label"].shape[0]
    held = [i for i, pair in enumerate(sample) if first <= pair < first + rows]
    want = dict(label=arrays["label"][held],
                **{side: {k: v[held] for k, v in arrays[side].items()}
                   for side in ("item1", "item2")})
    bad = ref_inputs.judge_pairs(want, kept["staged"], [int(sample[i]) - first for i in held])
    run.check("input_mismatch", bad, limits["input_mismatch"])
    if bad:
        return
    e1, e2, p, flops = reference_scores(run.spec.config, run.seed, arrays, device,
                                        count_flops=run.trace)
    if flops is not None:
        run.flops_per_item = flops
    # the window's batches in order: batch j holds pairs [(j % per_pass) * B, ...)
    per_pass = -(-n_pairs // batch)
    missing, worst = 0, dict(emb_l2_gap=0.0, logit_gap=0.0, emb_gap=0.0)
    for j, out in enumerate(kept["answers"]):
        first = ((kept["window_offset"] + j) % per_pass) * batch
        rows = [(i, pair - first) for i, pair in enumerate(sample)
                if first <= pair < first + out["probs"].shape[0]]
        due = [i for i, pair in enumerate(sample) if first <= pair < first + batch
               and pair < n_pairs]
        missing += len(due) - len(rows)
        if not rows:
            continue
        i_s = [i for i, _ in rows]
        r_s = [r for _, r in rows]
        got = (out["emb1"][r_s], out["emb2"][r_s], out["probs"][r_s])
        g = all_gaps(got, (e1[i_s], e2[i_s], p[i_s]))
        worst = {k: max(v, g[k]) for k, v in worst.items()}
    run.check("missing", missing, limits["missing"])
    run.check("emb_l2_gap", worst["emb_l2_gap"], limits["emb_l2_gap"])
    run.notes.update(logit_gap=worst["logit_gap"], emb_gap=worst["emb_gap"])
