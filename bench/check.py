"""Deciding ``correct``: the served tokens against the plain reference.

For each served token the reference's float32 logits at the position it
was served from give its gap: how far its logit lies below the
reference's best.  Greedy decoding serves the best token, so a sound run
reads only rounding's near-ties there.  Over every checked token:

* ``max_logit_gap``: the widest gap;
* ``logit_error_q10``, where the program hands out the logits it served
  from (the wave engine): each served token's |program logits - reference
  logits| / |reference logits| (2-norms over the vocabulary), its 10th
  percentile over the tokens of each stage (those prefills served, those
  first decode steps served, those later decode steps served), the
  largest of the three.  A MoE token meets a routing decision in every
  layer, and bf16's near-ties flip some of them, each moving the token's
  logits far; the low quantile reads the tokens that rounding alone
  moved, while a lower precision moves every token.  Taken a stage at a
  time, a fault in one stage shows (a cache that decode steps do not
  update leaves the first decode step right and every later one wrong).
* ``error_share``, where the program hands out its logits: the share
  of the checked tokens whose error is over the cell's ``over`` (set
  above nearly every token of sound runs, at about the control's
  median token).  It reads every row, so half of a wave's rows served
  wrong shows where the stages' quantile reads only the sound half.  A
  row that attends to left padding whose routing near-ties flipped
  (the pad token is one state repeated, routed once for all of them)
  can read as far as the control; it adds only its own few tokens.

A cell's limits file names the numbers it compares (and ``over``).  The
control (``fp8``) is the reference itself computed through float8
products, put in the program's place: at the same positions, the same
numbers of the token it puts first.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench.reference import common
from bench.served import Job


NAMES = ("max_logit_gap", "logit_error_q10", "error_share")


def numbers(gaps: torch.Tensor, errors: torch.Tensor, stage: torch.Tensor,
            over: Optional[float]) -> Dict[str, float]:
    nan = float("nan")
    stages = [errors[stage == k] for k in range(3) if bool((stage == k).any())]
    far = (float((errors > over).double().mean())
           if over is not None and errors.numel() else nan)
    return {"max_logit_gap": float(gaps.max()) if gaps.numel() else nan,
            "logit_error_q10": max((float(torch.quantile(e, 0.1)) for e in stages),
                                   default=nan),
            "error_share": far}


def _error(logits: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    logits = logits.to(ref.device, torch.float32)
    return ((logits - ref).norm(dim=-1) / ref.norm(dim=-1)).double().cpu()


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float64)


def read(ref, weights, arch, jobs: Sequence[Job], device, control: bool = False,
         detail: Optional[Dict[str, list]] = None,
         over: Optional[float] = None) -> Dict[str, float]:
    """The numbers of the program (and, with ``control``, of the control
    as ``control.<name>``), and ``tokens_checked``; ``error_share``
    counts the tokens whose error is over ``over``.  A ``detail`` dict
    receives each checked token's row, stage, gap and error (and the
    control's), for setting limits."""
    common.strict_float32()
    gaps: List[torch.Tensor] = []
    errors: List[torch.Tensor] = []
    stages: List[torch.Tensor] = []
    rows: List[torch.Tensor] = []
    ctl: List[torch.Tensor] = []
    ctl_errors: List[torch.Tensor] = []
    with torch.no_grad():
        for n, job in enumerate(jobs):
            tokens = torch.from_numpy(np.asarray(job.tokens, np.int64)).to(device)
            at = torch.from_numpy(np.asarray(job.at, np.int64)).to(device)
            served = torch.from_numpy(np.asarray(job.served, np.int64)).to(device)
            logits = ref.logits_at(weights, arch, tokens, at, groups=job.groups)
            best = logits.max(-1).values
            gaps.append((best - logits.gather(1, served[:, None])[:, 0]).double().cpu())
            if job.logits is not None:
                errors.append(_error(job.logits, logits))
                stages.append(torch.from_numpy(np.asarray(job.stage, np.int64)))
                # a row of a job is one request: the job's number, then its row
                rows.append(n * (1 << 20) + torch.from_numpy(np.asarray(job.at[:, 0], np.int64)))
            if control:
                low = ref.logits_at(weights, arch, tokens, at, groups=job.groups, fp8=True)
                pick = low.argmax(-1)[:, None]
                ctl.append((best - logits.gather(1, pick)[:, 0]).double().cpu())
                if job.logits is not None:
                    ctl_errors.append(_error(low, logits))
            del logits
    g = _cat(gaps)
    stage = torch.cat(stages) if stages else torch.zeros(0, dtype=torch.int64)
    row = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64)
    out = dict(numbers(g, _cat(errors), stage, over), tokens_checked=int(g.numel()))
    if control:
        out.update({f"control.{k}": v
                    for k, v in numbers(_cat(ctl), _cat(ctl_errors), stage, over).items()})
    if detail is not None:
        detail.update(row=row.tolist(), stage=stage.tolist(), gap=g.tolist(),
                      error=_cat(errors).tolist(), control_gap=_cat(ctl).tolist(),
                      control_error=_cat(ctl_errors).tolist())
    return out
