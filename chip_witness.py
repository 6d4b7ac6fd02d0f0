#!/usr/bin/env python3
"""Float64 witness of the values the benchmark's `correct` counts as off,
in the one-clip inference cells (stream432, scan432), on one NVIDIA GPU.

    python3 chip_witness.py <checkout> <cell> <seed> [<seed> ...]

Runs the cell (untraced, 10 s) from <checkout>, the port and the benchmark
both taken from there (`.` for this one). The benchmark's reference step
and exemplar preparation run twice: as the benchmark runs them (fp32
convolutions, TF32 off), and with every convolution computed in float64
and rounded to fp32. For the values the check counts as off (a carry ab
value more than 0.5, an output value more than 1 level from the fp32
reference) it counts those where the float64 reference lies within the
same distance of the program, of the fp32 reference, or of neither; and it
gives the harness's numbers against the float64 reference. One JSON line
a seed, also appended to chiprun_out/witness.jsonl beside this script."""

import json
import os
import sys

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "chiprun_out", "witness.jsonl")


def sides(prog, ref, ref64, tol):
    """Counts among the values off (|prog - ref| > tol)."""
    off = (prog - ref).abs() > tol
    with_prog = (prog - ref64).abs() <= tol
    with_ref = (ref - ref64).abs() <= tol
    return {"off": int(off.sum()), "values": off.numel(),
            "float64_with_program": int((off & with_prog).sum()),
            "float64_with_fp32_reference": int((off & with_ref).sum()),
            "float64_with_neither": int((off & ~with_prog & ~with_ref).sum()),
            "program_vs_float64_off": int(((prog - ref64).abs() > tol).sum()),
            "fp32_reference_vs_float64_off": int(
                ((ref - ref64).abs() > tol).sum())}


def main(argv) -> int:
    root = os.path.abspath(argv[0])
    cell, seeds = argv[1], [int(s) for s in argv[2:]]
    sys.path.insert(0, root)
    os.chdir(root)

    import torch
    import torch.nn.functional as F

    from benchmark import compare, harness
    from benchmark.reference import infer

    conv32 = F.conv2d

    def conv64(x, w, b=None, *args, **kwargs):
        return conv32(x.double(), w.double(),
                      None if b is None else b.double(), *args,
                      **kwargs).to(x.dtype)

    def in_float64(fn, *args):
        F.conv2d = conv64
        try:
            return fn(*args)
        finally:
            F.conv2d = conv32

    prep32, step32, numbers32 = (infer.prepare_reference, infer.step,
                                 compare.clip_numbers)
    states64, stash, witness = {}, [], {}

    def prepare_reference(models, ref):
        state = prep32(models, ref)
        states64[id(state)] = (state, in_float64(prep32, models, ref))
        return state

    def step(models, frames, last, state, temperature=1e-10, wls=True):
        out, carry = step32(models, frames, last, state, temperature, wls)
        out64, carry64 = in_float64(step32, models, frames, last,
                                    states64[id(state)][1], temperature, wls)
        stash.append((out64[0], carry64))
        return out, carry

    def clip_numbers(pairs):
        numbers = numbers32(pairs)
        assert len(stash) == len(pairs), (len(stash), len(pairs))
        total = {}
        for (p_out, r_out, p_carry, r_carry), (o64, c64) in zip(pairs,
                                                                stash):
            for kind, d in (
                    ("carry_ab", sides(p_carry[..., 1:3].float(),
                                       r_carry[..., 1:3].float(),
                                       c64[..., 1:3].float(), 0.5)),
                    ("px", sides(p_out.to(torch.int16),
                                 r_out.to(torch.int16),
                                 o64.to(torch.int16), 1))):
                t = total.setdefault(kind, dict.fromkeys(d, 0))
                for k, v in d.items():
                    t[k] += v
        witness["total"] = total
        witness["numbers_vs_float64"] = {
            k: v for k, v in numbers32(
                [(p, o64, c, c64) for (p, _, c, _), (o64, c64)
                 in zip(pairs, stash)]).items()
            if k in ("px_off", "px8_off_worst", "carry_ab_off")}
        return numbers

    infer.prepare_reference, infer.step = prepare_reference, step
    compare.clip_numbers = clip_numbers
    harness.set_cache_dirs()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    for seed in seeds:
        witness.clear()
        stash.clear()
        states64.clear()
        result = harness.run_cell(cell, seed, 10.0, False, "cuda")
        line = {"root": os.path.basename(root), "cell": cell, "seed": seed,
                "correct": result["correct"],
                "checks": {k: v["value"]
                           for k, v in result["checks"].items()},
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                **witness}
        print(json.dumps(line), flush=True)
        with open(OUT, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
