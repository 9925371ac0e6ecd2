"""Kernels C, D and I of several checkouts of this repository, on one card.

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

It times the binning stage of that frame's pose (`chip_smoke.frame_inputs`,
CUDA events; `binning.ms`) and hashes its bins (`binning.output`).

For kernel I it renders the same frame with chip_smoke.py's cap-156 knobs
(`CAP156`), records the one page cover at a cap above 128
(`texcache._cover_and_match`, the route's entry in every tree), holds its
four outputs to kernel B's plain version, and times the whole call through
its wrapper (`ms`, `cold_ms`), its device activities per call and their
time (`activities`, `busy_ms`, torch.profiler) and, where the tree still
has the two-kernel CUDA route (`ops/cover_two_cuda.py`), each step of it:
`block_cover` and `pix_match` through their wrappers and alone, and the
torch glue between them (`texcache._distinct_by_sort`); else the one
launch alone (`kernel_ms`). It also profiles two cap-156 frames (device
busy ms and activities per frame).

It prints one JSON line per TREE, then fails unless every TREE saw the same
inputs and gave bit-equal outputs. Give the trees in turns (parent, change,
change, parent) to compare times within one call. Needs a CUDA GPU.

    python3 kernel_ab.py --plain TREE [TREE ...]

times only the all-plain reference frame (`use_pallas=False,
use_tex_kernel=False`, the plain raster fold and the dense light sweep) of
the textured cell and of the 1024-light cell (`chip_smoke.lights1k_cell`'s
scene and knobs) at chip_smoke.py's pose, rendered eagerly (`eager()`):
one warm-up frame, then PLAIN_FRAMES frames on the host clock, synchronized
per frame (`ms`), and the last frame's hash (`output`), which must be the
same in every TREE.
"""

from __future__ import annotations

import contextlib
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


def _spans(cs, fn, reps: int, kernels: dict[str, int]):
    """Device activities (name, us) of `reps` runs of `fn` from a complete
    torch.profiler trace: one that holds `kernels[k]` launches a run of
    each device kernel named k (chip_smoke.traced; up to TRACE_TRIES)."""
    for _ in range(cs.TRACE_TRIES):
        spans, _, _ = cs.traced(lambda: [fn() for _ in range(reps)])
        held = {k: sum(1 for n, _ in spans if k in n) for k in kernels}
        if all(held[k] == n * reps for k, n in kernels.items()):
            return spans
        cs.TRACES["partial"].append(f"{held} of {reps} runs")
    cs.fail("ab", f"no complete trace of {sorted(kernels)}: {cs.TRACES['partial']}")


def _alone_ms(spans, kernel: str, reps: int) -> float:
    return sum(t for n, t in spans if kernel in n) / 1e3 / reps


def cover_i(cs, scene, cfg, knobs, cam) -> dict:
    """Kernel I on the cap-156 frame's lo-half cover (see the module doc)."""
    import torch

    from direct12pbrrenderer_tpu_torch.ops import cover_cuda, texcache
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline

    pipe = DeferredRenderPipeline(scene, cfg, device=torch.device("cuda", 0),
                                  tex_caps=cs.CAP156, **knobs)
    with cs.recording(texcache, "_cover_and_match") as calls:
        pipe.render(cam, collect_stats=False)
        torch.cuda.synchronize()
    def caps_of(args):
        cap = args[2]
        return cap if isinstance(cap, tuple) else (cap,) * args[0].shape[1]

    (args, kw), = [c for c in calls if max(caps_of(c[0])) > 128]
    pages, act, _, block_cap = args
    caps = caps_of(args)

    def route():
        return texcache._cover_and_match(*args, **kw)

    got = route()
    for g, w, what in zip(got, cover_cuda.fused_cover_reference(pages, act, caps, block_cap),
                          ("list", "count", "slot", "covered")):
        if not torch.equal(g, w):
            cs.fail("ab-I", f"{what} differs from kernel B's plain version")
    try:
        from direct12pbrrenderer_tpu_torch.ops import cover_two_cuda as two
    except ImportError:
        two = None
    reps = 20
    kernels = ({"fused_cover_kernel": 1} if two is None else
               {"block_cover_kernel": 1, "pix_match_kernel": 1})
    spans = _spans(cs, route, reps, kernels)
    out = {"inputs": _sha([*args, *sorted(kw.items())]), "output": _sha(got),
           "strides": [list(pages.stride()), list(act.stride())],
           "ms": cs.cuda_ms(route, 50), "cold_ms": cs.cold_ms(route, 50),
           "kernel_ms": sum(_alone_ms(spans, k, reps) for k in kernels),
           "busy_ms": sum(t for _, t in spans) / 1e3 / reps,
           "activities": len(spans) / reps}
    if two is not None:
        cand, slot_a = two.block_cover(pages, act, block_cap)
        tiles, g_ = cand.shape[:2]
        cap_arr = torch.tensor(caps, dtype=torch.int32, device=pages.device)[None, :]

        def glue():
            return texcache._distinct_by_sort(cand.reshape(tiles, g_, -1), max(caps), cap_arr)

        _, _, slot_b, found_b = glue()
        margs = (slot_a, slot_b.reshape(cand.shape), found_b.reshape(cand.shape), block_cap)
        b_spans = _spans(cs, lambda: two.block_cover(pages, act, block_cap), reps,
                         {"block_cover_kernel": 1})
        m_spans = _spans(cs, lambda: two.pix_match(*margs), reps, {"pix_match_kernel": 1})
        out.update({
            "block_cover_ms": cs.cuda_ms(lambda: two.block_cover(pages, act, block_cap), 50),
            "block_cover_kernel_ms": _alone_ms(b_spans, "block_cover_kernel", reps),
            "block_cover_busy_ms": sum(t for _, t in b_spans) / 1e3 / reps,
            "glue_ms": cs.cuda_ms(glue, 50),
            "pix_match_ms": cs.cuda_ms(lambda: two.pix_match(*margs), 50),
            "pix_match_kernel_ms": _alone_ms(m_spans, "pix_match_kernel", reps),
            "pix_match_busy_ms": sum(t for _, t in m_spans) / 1e3 / reps})
    wall, busy, n_act, _ = cs.profiled_frames(pipe, cam, 2)
    out["frame"] = {"wall_ms": wall, "busy_ms": busy, "activities": n_act}
    return out


def run_one(tree: str) -> dict:
    import torch

    cs = _import_port(tree)
    from direct12pbrrenderer_tpu_torch.ops import resolve_shade_cuda, shade_fused

    scene, cfg, _, knobs, pipe, cam = cs.textured_cell(torch.device("cuda", 0))
    _, bins, _, stage_ms = cs.frame_inputs(pipe, cam)
    binning = {"output": _sha([bins.ids, bins.counts]), "ms": stage_ms["binning"]}
    del bins
    with cs.recording(resolve_shade_cuda, "resolve_shade") as c_calls, \
            cs.recording(shade_fused, "deferred_kernel") as d_calls:
        pipe.render(cam, collect_stats=False)
        torch.cuda.synchronize()
    out = {"tree": tree, "smi": _smi()}
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
    del pipe
    out["I"] = cover_i(cs, scene, cfg, knobs, cam)
    out["binning"] = binning
    return out


PLAIN_FRAMES = 3


def _import_port(tree: str):
    """chip_smoke (this checkout's) and the port of `tree`, on a card."""
    import torch

    import chip_smoke as cs

    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import direct12pbrrenderer_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        cs.fail("ab", f"imported the port from {port.__file__}, not from {root}")
    if not torch.cuda.is_available():
        cs.fail("ab", "needs a CUDA GPU")
    return cs


def run_plain(tree: str) -> dict:
    """The all-plain frame of the textured and the 1024-light cell, eager."""
    import time

    import torch

    cs = _import_port(tree)
    from direct12pbrrenderer_tpu_torch.pipeline import deferred

    eager = getattr(deferred, "eager", contextlib.nullcontext)
    dev = torch.device("cuda", 0)
    scene, cfg, _, knobs, pipe, cam = cs.textured_cell(dev)
    del pipe
    cells = {"textured": (scene, cfg, knobs)}
    scene, cfg, l1k_knobs, pipe = cs.lights1k_cell(dev, knobs)
    del pipe
    cells["lights1k"] = (scene, cfg, l1k_knobs)
    out = {"tree": tree, "smi": _smi()}
    for cell, (scene, cfg, kn) in cells.items():
        ref = deferred.DeferredRenderPipeline(scene, cfg, use_pallas=False,
                                              use_tex_kernel=False, device=dev, **kn)
        ms = []
        with eager():
            for i in range(1 + PLAIN_FRAMES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = ref.render(cam, collect_stats=False)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        out[cell] = {"ms": ms[1:], "output": _sha([img])}
        del ref, img
        torch.cuda.empty_cache()
    return out


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main() -> None:
    if sys.argv[1:2] in (["--one"], ["--one-plain"]):
        run = run_one if sys.argv[1] == "--one" else run_plain
        print(json.dumps(run(sys.argv[2])), flush=True)
        return
    plain = sys.argv[1:2] == ["--plain"]
    trees = sys.argv[1 + plain:]
    if not trees:
        sys.exit(__doc__)
    lines = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one-plain" if plain else "--one", tree],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            sys.exit(f"[ab] FAIL {tree}: exit code {proc.returncode}")
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)
    if plain:
        for cell in ("textured", "lights1k"):
            seen = {line[cell]["output"] for line in lines}
            if len(seen) != 1:
                sys.exit(f"[ab] FAIL all-plain {cell} frame differs across trees: {seen}")
            print(f"[ab] all-plain {cell} frame: bit-equal in {len(lines)} runs; mean ms "
                  + ", ".join(f"{l['tree']} {sum(l[cell]['ms']) / PLAIN_FRAMES:.2f}"
                              for l in lines), flush=True)
        return
    for key in ("C", "D", "I", "binning"):
        for what in ("inputs", "output")[key == "binning":]:
            seen = {line[key][what] for line in lines}
            if len(seen) != 1:
                sys.exit(f"[ab] FAIL kernel {key}: {what} differ across trees: {seen}")
        print(f"[ab] {'kernel ' * (key != 'binning')}{key}: the same inputs and bit-equal "
              f"outputs in {len(lines)} runs; "
              "ms through the wrapper " + ", ".join(f"{l['tree']} {l[key]['ms']:.4f}"
                                                    for l in lines), flush=True)


if __name__ == "__main__":
    main()
