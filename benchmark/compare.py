"""The numbers that decide `correct`, and the rule that turns them into a
verdict.

Inference cells. The reference follows the program teacher-forced: for
each sampled frame it takes the carry the program entered that frame with
(its previous prediction), and recomputes the frame's uint8 output and its
new carry from the frame, the exemplar and the weights. At T = 1e-10 the
softmax is an argmax, and random weights amplify a one-frame difference
about 20x a frame (ROADMAP C3), so a free-running comparison over a clip
measures chaos, not the program. Frame 0, from the zero carry, is always
sampled: the start is checked from nothing the program made.

On a few frames of some clips one near-tie goes the other way between
two computations whose convolutions round differently, and the random
networks' instance norms spread it over part of the frame. The program's
convolutions are fp32-accurate products (3xTF32) and decide such ties
as float64 does where plain fp32 convolutions do not, so the reference
computes its convolutions in float64 (reference/infer.py). A lower
precision or a broken step moves every frame it touches by more than
such a frame moves, so the numbers are read both over all sampled
frames together and for the worst sampled frame alone (PERF.md gives the
readings):

  px_off          the share of output uint8 values more than 1 from the
                  reference, over all sampled frames
  px_off_worst    the same for the worst sampled frame alone (frame 0
                  among them)
  carry_ab_off    the share of the carry's predicted ab values more than
                  0.5 from the reference's, over all sampled frames
  carry_ab_off_worst  the same for the worst sampled frame alone
  carry_l_off     the same for the carry's L (the frame's own L: no
                  argmax reaches it), over all sampled frames
  px8_off_worst   the worst sampled frame's share of output values more
                  than 8 from the reference's
  mad_worst       the worst sampled frame's mean absolute gap, in levels
  frames_off      how many sampled frames have a share over 1%, and
  px_frames, px8_frames, mad_frames, ab_frames  each sampled frame's
                  readings: for the record
"""

from __future__ import annotations

import torch


def clip_numbers(pairs) -> dict:
    """pairs: [(prog_out, ref_out, prog_carry, ref_carry)] of one sample
    each (uint8 [H, W, 3] outputs, fp32 [..., 3] carries [L, a, b], on one
    device)."""
    if not pairs:
        return {}
    px, px8, mad, ab = [], [], [], []
    off = vals = ab_off = ab_vals = l_off = l_vals = 0
    for prog_out, ref_out, prog_carry, ref_carry in pairs:
        gap = (prog_out.to(torch.int16) - ref_out.to(torch.int16)).abs()
        d = gap > 1
        c = (prog_carry.float() - ref_carry.float()).abs() > 0.5
        px.append(float(d.float().mean()))
        px8.append(float((gap > 8).float().mean()))
        mad.append(float(gap.float().mean()))
        ab.append(float(c[..., 1:3].float().mean()))
        off, vals = off + int(d.sum()), vals + d.numel()
        ab_off += int(c[..., 1:3].sum())
        ab_vals += c[..., 1:3].numel()
        l_off += int(c[..., 0].sum())
        l_vals += c[..., 0].numel()
    return {"px_off": off / vals, "px_off_worst": max(px),
            "px8_off_worst": max(px8), "mad_worst": max(mad),
            "carry_ab_off": ab_off / ab_vals, "carry_ab_off_worst": max(ab),
            "carry_l_off": l_off / l_vals,
            "frames_off": sum(p > 0.01 or a > 0.01 for p, a in zip(px, ab)),
            "px_frames": [round(p, 4) for p in px],
            "px8_frames": [round(p, 4) for p in px8],
            "mad_frames": [round(m, 3) for m in mad],
            "ab_frames": [round(a, 4) for a in ab]}


def batch_numbers(prog: dict, ref: dict) -> dict:
    """A loader batch against the reference's rebuild of it from the same
    files and draws:
      batch_off  the share of all its values off: the uint8 images'
                 (`*_rgb`) by more than 1 level (the C++ and the plain
                 float64 resize round apart), every other field's (flows,
                 the 0/1 mask, jitter, flags) by more than 1e-2"""
    off = vals = 0
    for k, r in ref.items():
        p = torch.as_tensor(prog[k]).double()
        r = torch.as_tensor(r).double()
        if p.shape != r.shape:
            return {"batch_off": 1.0}
        tol = 1.0 if k.endswith("_rgb") else 1e-2
        off += int(((p - r).abs() > tol).sum())
        vals += r.numel()
    return {"batch_off": off / vals}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every limited number present and at most its
    limit; a number that is missing or not finite fails. Numbers without
    a limit are the record's, not the verdict's."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = (value is not None and value == value  # NaN fails
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def _leaf_norms(flat, sizes):
    return torch.stack([t.norm() for t in torch.split(flat, sizes)])


def _leaf_gaps(prog, ref, sizes, keep):
    """Per kept leaf, |norm(prog) - norm(ref)| over the larger of
    norm(ref) and the median leaf's norm(ref)."""
    p, r = _leaf_norms(prog, sizes), _leaf_norms(ref, sizes)
    scale = torch.maximum(r, r[keep].median())
    return ((p - r).abs() / scale)[keep]


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training cells' numbers (drivers/train.py's readings):
      loss_gap         the first step's total and critic losses, the larger
                       relative gap (same weights, batch and noise on both
                       sides: a forward pass)
      loss_gap_later   the same over the later checked steps
      grad_gap         the first gradient as each optimizer got it, the
                       worst leaf's gap of norms
      grad_gap_median  the same, the median leaf's
      step_gap         the parameters' change over the checked steps, the
                       worst leaf's gap of norms
      step_gap_median  the same, the median leaf's
    A leaf's gap is over the larger of its reference norm and the median
    leaf's. Leaves whose reference gradient is under a thousandth of the
    median leaf's (nought to rounding, moved by round-off alone under
    Adam) are left out of the leaf numbers."""
    def gap(steps):
        return max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
                   for p, r in steps for k in r)

    pairs = list(zip(prog["losses"], ref["losses"]))
    sizes = ref["leaves"]
    g_ref = _leaf_norms(ref["grads"], sizes)
    keep = g_ref >= 1e-3 * g_ref.median()
    grads = _leaf_gaps(prog["grads"], ref["grads"], sizes, keep)
    steps = _leaf_gaps(prog["delta"], ref["delta"], sizes, keep)
    return {"loss_gap": gap(pairs[:1]),
            "loss_gap_later": gap(pairs[1:]) if len(pairs) > 1 else 0.0,
            "grad_gap": float(grads.max()),
            "grad_gap_median": float(grads.median()),
            "step_gap": float(steps.max()),
            "step_gap_median": float(steps.median()),
            "leaves_left_out": int((~keep).sum())}
