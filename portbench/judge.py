"""Whether the rounds a subject ran agree with the plain reference.

The subject is the port, or (for the control) the reference in TF32. The
reference follows it round by round from the same inputs. Everything it
compares, it works out itself, with one exception: the imputation round's
outcome. The top-k choice is discrete, and links whose scores tie to
rounding may be chosen either way; and the imputed features X̅ = f(S) come
from an adversarial training that carries rounding far on some seeds (one
server's X̅ most). So on each imputation round the reference judges the
links the subject wired into its imputation slots, each by how far its
score, in the reference's own arithmetic, falls short of the k-th best of
its row and of the ``aug_max``-th best link of its client, and by how far
the imputed features lie from the reference's X̅ row of the node they
name; then it wires the same links with the subject's features, and goes
on. The generator stage it thus takes from the subject is judged by
itself: ``gen_grad_gap``, ``xbar_gap_median``, ``link_gap`` and
``slots_gap``.

The numbers a cell compares are the keys of its ``limits/<workload>.json``:

- ``loss_abs_gap``: max over rounds of the absolute gap of the evaluation
  loss (the mean client loss of the aggregated classifiers, in nats). On
  a few seeds in a hundred the two sides' trajectories part by rounding
  from the second round on (Adam at a small loss), with the first step's
  gradients equal and every accuracy the same, and it reads up to ~1e-4;
- ``grad_gap_clf``: over the classifier's leaves, the worst gap between
  the norms of the first local step's gradient on the two sides (the
  subject's as its optimizer holds it after that step), over the larger
  of the reference leaf's norm and the median leaf's;
- ``gen_grad_gap``: the same for the first AE step's and the first
  assessor step's gradients on the first imputation round (servers
  stacked), each network's leaves over its own median leaf's. It swings
  from seed to seed: both steps follow Adam steps (the round's local
  training, and the AE's steps before the assessor's), whose noise moves
  the embeddings by up to a few 1e-3, so Eq. 13's mask (H > 1/c) can
  differ in an entry that lies that close to the threshold;
- ``change_gap_clf``: the same for each classifier leaf's change from the
  inputs' weights to the end of the first ``CHANGE_ROUNDS`` rounds (the
  later rounds' losses are compared, their changes not: on some seeds a
  rounding-level difference parts every leaf in a later round);
- ``xbar_gap_median``: on the first imputation round, the median over the
  imputed rows of their relative distance from the reference's X̅ row of
  the node they name: the generator and assessor training, X̅ = f(S);
- ``link_gap``: the largest shortfall of a wired link's score (1.0 for a
  link no search could return);
- ``slots_gap``: how many imputation slots the two sides fill or wire
  differently, summed over clients and rounds.

Also read, and compared by no cell (``calibrate.py`` prints them):
``loss_gap`` (the relative gap, which the loss's fall towards zero by the
last round makes a measure of rounding), ``acc_gap`` and ``f1_gap`` (one
test node flipping at a rounding tie moves them as far as the control
does) and ``xbar_gap`` (the widest X̅ row: the adversarial training
amplifies rounding).

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's (a bias that the loss cannot see) move by round-off alone
and are left out of the leaf gaps.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

from portbench.reference import fgl as ref_lib

NUMBERS = ("loss_abs_gap", "grad_gap_clf", "gen_grad_gap", "change_gap_clf", "xbar_gap_median",
           "link_gap", "slots_gap", "loss_gap", "acc_gap", "f1_gap", "xbar_gap")
NOUGHT = 1e-3
CHANGE_ROUNDS = 3
SAME = 1e-4   # X̅ rows this close (squared, relative) impute the same features
CLASSIFIER, GENERATOR = "params.", ("ae.", "assessor.")


def _identify(r: ref_lib.Reference, aug: Dict, readings: Dict) -> ref_lib.Choice:
    """The subject's links of this round in the reference's index space,
    judged against the reference's own search. A slot's node is the one
    whose X̅ row its features are; where several rows are the same (an
    encoder whose hidden units are all off gives its bias), the best
    scoring of them, since the slot's features do not tell them apart."""
    dev = r.batch["x"].device
    own = r.own_choice()
    ok, src = aug["ok"].to(dev), aug["src"].to(dev)
    wired = aug["wired"].to(dev)
    feats = aug["x"].to(dev)
    readings["slots_gap"] += float((ok != own.ok).sum() + (wired != ok.float()).sum())
    tgt = torch.full_like(src, -1)
    local = torch.arange(r.n_pad, device=dev) < r.n_local
    client = torch.arange(r.mp, device=dev).repeat_interleave(r.n_pad)
    for i in range(r.m):
        j, ci = divmod(i, r.mp)
        lk, xb, h = r.links[j], r.x_bar[j], r.h_flat[j]
        target = r.fmask[j] * local.repeat(r.mp).float()
        real = local & (r.batch["node_mask"][i] > 0)
        rows_i = slice(ci * r.n_pad, (ci + 1) * r.n_pad)
        link_vals = torch.where(real[:, None] & (lk.idx[rows_i] >= 0), lk.vals[rows_i],
                                -torch.inf)
        bar = torch.sort(link_vals.reshape(-1), descending=True).values[r.aug - 1]
        slots = torch.nonzero(ok[i]).flatten()
        if len(slots) == 0:
            continue
        f = feats[i, slots]
        rows = ci * r.n_pad + src[i, slots]
        d2 = (f * f).sum(1, keepdim=True) - 2 * f @ xb.T + (xb * xb).sum(1)[None, :]
        near = d2 <= d2.min(1, keepdim=True).values + SAME * (f * f).sum(1, keepdim=True)
        fits = near & (client[None, :] != ci) & (target[None, :] > 0)
        scores = torch.where(fits, h[rows] @ h.T, -torch.inf)
        t = torch.where(fits.any(1), scores.argmax(1), d2.argmin(1))
        tgt[i, slots] = t
        dist = (f - xb[t]).norm(dim=1) / torch.clamp_min(xb[t].norm(dim=1), 1e-30)
        readings["xbar_gap"] = max(readings["xbar_gap"], float(dist.max()))
        if r.round == 0:
            readings["xbar_rows"] += dist.tolist()
        score = (h[rows] * h[t]).sum(1)
        admissible = ((client[t] != ci) & (target[t] > 0) & (r.fmask[j][rows] > 0)
                      & (src[i, slots] < r.n_local))
        short = torch.clamp_min(torch.maximum(lk.kth[rows] - score, bar - score), 0.0)
        short = torch.where(admissible, short, torch.ones_like(short))
        readings["link_gap"] = max(readings["link_gap"], float(short.max()))
    return ref_lib.Choice(ok=ok, src=src, tgt=tgt, feats=feats)


def follow(r: ref_lib.Reference, subject: List[Dict]) -> Tuple[List[Dict], Dict[str, float]]:
    """Run ``r`` for as many rounds as ``subject`` holds after its initial
    snapshot, judging and taking the subject's links on imputation rounds."""
    readings = {"link_gap": 0.0, "xbar_gap": 0.0, "slots_gap": 0.0, "xbar_rows": []}
    out = [subject[0]]
    for t in range(1, len(subject)):
        out.append(r.step(lambda rr, aug=subject[t]["aug"]: _identify(rr, aug, readings)))
    rows = readings.pop("xbar_rows")
    readings["xbar_gap_median"] = float(statistics.median(rows)) if rows else 0.0
    return out, readings


def _leaf_gap(sub: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Dict[str, bool]) -> float:
    """The worst gap between the two sides' norms of each kept leaf, over
    the larger of the reference leaf's norm and the median leaf's."""
    names = [k for k in keep if keep[k]]
    norms = {k: float(ref[k].norm()) for k in names}
    med = statistics.median(norms.values())
    return max(abs(float(sub[k].norm()) - norms[k]) / max(norms[k], med, 1e-30)
               for k in names)


def compare(subject: List[Dict], reference: List[Dict], readings: Dict[str, float]
            ) -> Dict[str, float]:
    """The numbers of the module docstring, from snapshot 0 (the inputs) on."""
    out = dict(readings)
    rounds = range(1, len(subject))
    out["loss_abs_gap"] = max(abs(subject[t]["loss"] - reference[t]["loss"]) for t in rounds)
    out["loss_gap"] = max(abs(subject[t]["loss"] - reference[t]["loss"])
                          / max(abs(reference[t]["loss"]), 1e-30) for t in rounds)
    out["acc_gap"] = max(abs(subject[t]["acc"] - reference[t]["acc"]) for t in rounds)
    out["f1_gap"] = max(abs(subject[t]["f1"] - reference[t]["f1"]) for t in rounds)
    g_ref = reference[1]["grad0"]
    med = statistics.median(float(v.norm()) for v in g_ref.values())
    keep = {k: float(v.norm()) >= NOUGHT * med for k, v in g_ref.items()}
    t = min(CHANGE_ROUNDS, len(subject) - 1)
    first, last_s, last_r = (s["params"] for s in (subject[0], subject[t], reference[t]))
    out["grad_gap_clf"] = _leaf_gap(subject[1]["grad0"], g_ref, keep)
    gen_s, gen_r = subject[1]["gen_grad0"], reference[1]["gen_grad0"]
    out["gen_grad_gap"] = 0.0
    for net in GENERATOR:
        norms = {k: float(v.norm()) for k, v in gen_r.items() if k.startswith(net)}
        med = statistics.median(norms.values())
        out["gen_grad_gap"] = max(out["gen_grad_gap"], _leaf_gap(
            gen_s, gen_r, {k: v >= NOUGHT * med for k, v in norms.items()}))
    out["change_gap_clf"] = _leaf_gap(
        {k: last_s[CLASSIFIER + k] - first[CLASSIFIER + k] for k in g_ref},
        {k: last_r[CLASSIFIER + k] - first[CLASSIFIER + k] for k in g_ref}, keep)
    return out
