"""Kernels C and D of several checkouts of this repository, on one card.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (`.` for this one; another one, e.g. a
parent commit, unpacked with `git archive` into an ignored directory such
as `build/parent`). For each TREE, in the order given, a fresh process
imports the port from that checkout (building its kernels there), renders
chip_smoke.py's default 1920x1080 frame of the textured stress cell once
(`chip_smoke.textured_cell`, so the two scripts render one frame),
records the inputs of kernel C (`resolve_shade_cuda.resolve_shade`) and
kernel D (`shade_fused.deferred_kernel`), and for each kernel:

* holds it to its plain version with chip_smoke.py's bars;
* times it through its wrapper (CUDA events, `ms`; `cold_ms` with the L2
  evicted before each call), and its own kernel and
  all the call's device work (torch.profiler, `kernel_ms` and `busy_ms`;
  `copy_ms` is their difference: the wrapper's layout copies);
* hashes its inputs and its output (sha256 of the values).

It prints one JSON line per TREE, then fails unless every TREE saw the same
inputs and gave bit-equal outputs. Give the trees in turns (parent, change,
change, parent) to compare times within one call. Needs a CUDA GPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys


def _sha(xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        if hasattr(x, "contiguous"):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        else:
            h.update(repr(x).encode())
    return h.hexdigest()[:16]


def run_one(tree: str) -> dict:
    import torch

    import chip_smoke as cs

    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import direct12pbrrenderer_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        cs.fail("ab", f"imported the port from {port.__file__}, not from {root}")
    if not torch.cuda.is_available():
        cs.fail("ab", "needs a CUDA GPU")
    from direct12pbrrenderer_tpu_torch.ops import resolve_shade_cuda, shade_fused

    _, _, _, _, pipe, cam = cs.textured_cell(torch.device("cuda", 0))
    with cs.recording(resolve_shade_cuda, "resolve_shade") as c_calls, \
            cs.recording(shade_fused, "deferred_kernel") as d_calls:
        pipe.render(cam, collect_stats=False)
        torch.cuda.synchronize()
    out = {"tree": tree, "smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()}
    for key, calls, mod, fn, ref, kname, check in (
            ("C", c_calls, resolve_shade_cuda, "resolve_shade", "resolve_shade_reference",
             "resolve_shade", cs.check_shade),
            ("D", d_calls, shade_fused, "deferred_kernel", "deferred_kernel_reference",
             "deferred_shade", cs.check_deferred)):
        (args, kw), = calls
        wrap = getattr(mod, fn)
        got = wrap(*args, **kw)
        check(f"ab-{key}", got, getattr(mod, ref)(*args, **kw))
        ms = cs.cuda_ms(lambda: wrap(*args, **kw), 50)
        cold = cs.cold_ms(lambda: wrap(*args, **kw), 50)
        alone, busy = cs.device_ms(lambda: wrap(*args, **kw), 20, kname)
        out[key] = {"inputs": _sha([*args, *sorted(kw.items())]), "output": _sha([got]),
                    "ms": ms, "cold_ms": cold, "kernel_ms": alone, "busy_ms": busy, "copy_ms": busy - alone,
                    "strides": {i: list(a.stride()) for i, a in enumerate(args)
                                if isinstance(a, torch.Tensor) and not a.is_contiguous()}}
    return out


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return
    trees = sys.argv[1:]
    if not trees:
        sys.exit(__doc__)
    lines = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            sys.exit(f"[ab] FAIL {tree}: exit code {proc.returncode}")
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)
    for key in ("C", "D"):
        for what in ("inputs", "output"):
            seen = {line[key][what] for line in lines}
            if len(seen) != 1:
                sys.exit(f"[ab] FAIL kernel {key}: {what} differ across trees: {seen}")
        print(f"[ab] kernel {key}: the same inputs and bit-equal outputs in {len(lines)} runs; "
              "ms through the wrapper " + ", ".join(f"{l['tree']} {l[key]['ms']:.4f}"
                                                    for l in lines), flush=True)


if __name__ == "__main__":
    main()
