"""Rank bodies for tests/test_torch_sharded.py and
tests/test_torch_sharded_paths.py, run by `frame_sharded.launch` in spawned
processes. Kept out of the test modules so that a rank imports torch and
the port only (the scenes and configs handed to it are the JAX package's
host objects, read by attribute)."""

import numpy as np
import torch

from direct12pbrrenderer_tpu_torch.ops import bloom, postprocess
from direct12pbrrenderer_tpu_torch.parallel import frame_sharded
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.state import state_from_jax
from torch_host_reads import no_host_reads


def band_frame(mesh, scene, cfg, knobs, state, cam, single=False):
    """The band frame of `cam` with collect_stats, gathered on every rank,
    from a pipeline with `state` (the JAX pipeline's buffers) loaded; rank 0
    also renders the single-device frame of the same pose with `single`."""
    torch.set_num_threads(2)
    pipe = DeferredRenderPipeline(scene, cfg, device=mesh.device, **knobs)
    pipe.load_state(state_from_jax(state, mesh.device))
    frame = frame_sharded.build_sharded_frame(mesh, pipe, collect_stats=True)
    band, avg, bin_counts, tex, trunc, env = frame(
        *frame_sharded.frame_args(pipe, cam, pipe.avg_luminance))
    out = dict(frame=frame_sharded.gather_rows(mesh, band).numpy(), band=band.numpy(),
               avg=float(avg), bin_counts=bin_counts.numpy(), tex_approx=int(tex),
               light_trunc=int(trunc), env_approx=int(env),
               paths=(pipe.use_fused_gbuffer, pipe.use_fused_deferred, pipe.light_tile))
    if single and mesh.rank == 0:
        out["single"] = pipe.render(cam).numpy()
        out["single_avg"] = float(pipe.avg_luminance)
    return out


def post_chain(mesh, hdrs):
    """For each (H, W, 3) HDR frame in `hdrs`: this rank's rows of the band
    bloom, and the exposure EMA from the bands' summed luminance sums."""
    torch.set_num_threads(2)
    out = []
    for hdr in hdrs:
        band_h = hdr.shape[0] // mesh.size
        band = torch.as_tensor(np.ascontiguousarray(hdr[mesh.rank * band_h:
                                                        (mesh.rank + 1) * band_h]))
        bloomed = bloom.bloom_band(band, hdr.shape[0], mesh)
        sums = mesh.all_reduce(postprocess.luminance_sums(band))
        avg = postprocess.average_luminance_from_sums(
            sums, float(hdr.shape[0] * hdr.shape[1]), torch.tensor(0.3), 1.0 / 60.0)
        out.append((bloomed.numpy(), avg.numpy()))
    return out


def band_paths(mesh, scene, cfg, paths, poses):
    """For each path of `paths` ({name: pipeline knobs}): a band frame of
    poses[0] (the warm-up that fills the device constants' caches, as a
    capture's warm-up does), then one of poses[1] from its exposure carry,
    on the device, under `no_host_reads` (what it caught is listed, so that
    no rank stops inside a collective). Every rank returns the gathered
    second frame with its collect_stats outputs and carry; rank 0 also the
    outputs of its own `render(poses[1])` from the same carry (`_frame`'s:
    the frame, the carry, bin counts, fallback taps and truncation)."""
    torch.set_num_threads(2)
    out = {}
    for name, knobs in paths.items():
        pipe = DeferredRenderPipeline(scene, cfg, device=mesh.device, **knobs)
        frame = frame_sharded.build_sharded_frame(mesh, pipe, collect_stats=True)
        carry = frame(*frame_sharded.frame_args(pipe, poses[0], pipe.avg_luminance))[1]
        args = frame_sharded.frame_args(pipe, poses[1], carry)
        found = []
        with no_host_reads(found):
            band, *rest = frame(*args)
        res = dict(band=[frame_sharded.gather_rows(mesh, band).numpy(),
                         *(x.numpy() for x in rest)], host_reads=found)
        if mesh.rank == 0:
            recorded = []
            run = pipe._frame

            def record(*a):
                recorded.append(run(*a))
                return recorded[-1]

            pipe._frame = record
            pipe.avg_luminance = carry
            pipe.render(poses[1])
            res["render"] = [x.numpy() for x in recorded[0][:6]]
        out[name] = res
    return out


def band_carry(mesh, scene, cfg, knobs, state, poses):
    """The exposure carry of band frames over `poses`, chained on the
    device from the loaded state's, read back after the last frame."""
    torch.set_num_threads(2)
    pipe = DeferredRenderPipeline(scene, cfg, device=mesh.device, **knobs)
    pipe.load_state(state_from_jax(state, mesh.device))
    frame = frame_sharded.build_sharded_frame(mesh, pipe)
    avg, avgs = pipe.avg_luminance, []
    for cam in poses:
        avg = frame(*frame_sharded.frame_args(pipe, cam, avg))[1]
        avgs.append(avg)
    return [a.numpy() for a in avgs]
