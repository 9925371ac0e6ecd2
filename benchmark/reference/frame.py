"""One frame of the reference renderer: precompute once, then a pose (and
the previous frame's exposure) -> the 8-bit frame, its new exposure and
its counts."""

from __future__ import annotations

import numpy as np
import torch

from . import ibl, post, raster, shade
from .camera import pose_matrices
from .texture import CubeMips, MipTexture, mip_chain

PREFILTER_MAX = 512


def frustum_visible(planes, mins, maxs):
    """(N,) bool: no AABB lies wholly behind one of the six planes."""
    n, d = planes[:, :3], planes[:, 3]
    p = torch.where(n[None] > 0, maxs[:, None, :], mins[:, None, :])
    return torch.all((p * n[None]).sum(-1) + d[None] >= 0, dim=1)


class Reference:
    """The scene's derived state (mips, IBL, light attenuation) on
    `device`, from the raw scene arrays alone."""

    def __init__(self, scene: dict, cfg: dict, device, dtype=torch.float32):
        self.dev, self.dtype = torch.device(device), dtype
        self.cfg = cfg
        mesh = scene["mesh"]
        dev = self.dev
        self.positions = torch.as_tensor(mesh["positions"], device=dev)
        self.normals = torch.as_tensor(mesh["normals"], device=dev)
        self.tangents = torch.as_tensor(mesh["tangents"], device=dev)
        self.uvs = torch.as_tensor(mesh["uvs"], device=dev)
        self.tris = torch.as_tensor(mesh["tris"].astype(np.int64), device=dev)
        eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        self.vattr = torch.cat([self.uvs, raster.transform_directions(self.normals, eye3),
                                raster.transform_directions(self.tangents, eye3)], 1)
        self.bounds = torch.tensor([mesh["bound_min"], mesh["bound_max"]], dtype=torch.float32,
                                   device=dev)
        self.material = scene["material"]
        self.albedo = (MipTexture(mip_chain(scene["albedo_map"], cfg["atlas_max_dim"]), True,
                                  dev) if self.material["albedo_map"] else None)
        lg = dict(scene["lights"])
        n_l = len(lg["intensity"])
        lg["attenuation"] = np.stack([attenuation(r) for r in lg["radius"]]) if n_l else \
            np.zeros((0, 4), np.float32)
        # culling boxes: centre +- 1.814 r sqrt(I), the corners rounded to
        # float32 from a float64 sum as the scene's transform rounds them
        r = lg["radius"] * 1.814 * np.sqrt(lg["intensity"])
        t = lg["translation"].astype(np.float64)
        lo = (t + (-r).astype(np.float32).astype(np.float64)[:, None]).astype(np.float32)
        hi = (t + r.astype(np.float32).astype(np.float64)[:, None]).astype(np.float32)
        self.light_box = (torch.as_tensor(np.minimum(lo, hi), device=dev),
                          torch.as_tensor(np.maximum(lo, hi), device=dev))
        self.lights = lg
        faces = torch.as_tensor(scene["sky"], device=dev)
        src = CubeMips(ibl.box_mips(faces))
        size = min(PREFILTER_MAX, faces.shape[1])
        self.ibl = {"lut": ibl.brdf_lut(cfg["brdf_lut_size"], dev),
                    "prefiltered": CubeMips(ibl.prefilter(src, size)),
                    "sky": CubeMips([faces]),
                    "sh": torch.as_tensor(ibl.sh_pack(scene["sky"]), device=dev)}

    def _camera(self, pose: dict) -> dict:
        cfg = self.cfg
        m = pose_matrices(pose["position"], pose["yaw"], pose["pitch"], cfg["fov"],
                          cfg["width"], cfg["height"], cfg["near"], cfg["far"])
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=self.dev)
                for k, v in m.items()}

    def stats(self, pose: dict) -> dict:
        """The counters the program reports for a frame (its `FrameStats`)
        as this renderer has them at `pose`: the mesh and the lights in the
        frustum, the lights beyond `max_active_lights`. It drops no
        triangle, texture or environment tap and no light of a tile, so
        those losses are 0."""
        planes = self._camera(pose)["planes"]
        seen = int(frustum_visible(planes, self.bounds[0:1], self.bounds[1:2])[0])
        lights = (int(frustum_visible(planes, *self.light_box).sum())
                  if len(self.lights["intensity"]) else 0)
        return {"visible_instances": seen, "total_instances": 1, "visible_lights": lights,
                "bin_overflow": 0, "tex_approx_taps": 0, "env_approx_taps": 0,
                "lights_truncated": max(0, lights - self.cfg["max_active_lights"]),
                "light_tile_overflow": 0}

    def _visible(self, pose: dict):
        """The pose's camera tensors, raster (setup, ids, depth, drawn
        triangles) and visible light rows."""
        cfg, dev = self.cfg, self.dev
        w, h = cfg["width"], cfg["height"]
        cam = self._camera(pose)
        planes = cam["planes"]
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        tris = self.tris
        if not bool(frustum_visible(planes, self.bounds[0:1], self.bounds[1:2])[0]):
            tris = tris[:0]
        clip = raster.vertex_transform(self.positions, eye, cam["view_proj"])
        setup = raster.setup_triangles(clip, tris, w, h)
        tri_id, depth = raster.rasterize(setup, w, h)
        valid = frustum_visible(planes, *self.light_box) if len(self.lights["intensity"]) \
            else torch.zeros(0, dtype=torch.bool, device=dev)
        rows = shade.light_rows(self.lights, valid, cam["view"], dev)[:cfg["max_active_lights"]]
        return cam, setup, tri_id, depth, tris, rows, valid

    def counts(self, pose: dict) -> dict:
        """The pose's work counts: pixels, covered pixels, light rows, lit
        (covered pixel, listed light) pairs."""
        cfg = self.cfg
        w, h = cfg["width"], cfg["height"]
        cam, _, tri_id, depth, _, rows, valid = self._visible(pose)
        mask = tri_id >= 0
        near, far = cfg["near"], cfg["far"]
        z_view = near * far / (far - depth * (far - near))
        lists, _ = shade.cluster_lists(rows, cfg["fov"], w / h, near, far)
        sx, sy, sz = shade.cluster_of(z_view, h, w, near, far)
        mine = lists[((sx * shade.CLUSTERS[1] + sy) * shade.CLUSTERS[2] + sz).long()]
        return {"pixels": w * h, "covered": int(mask.sum()), "lights": int(rows.shape[0]),
                "lit_pairs": int(((mine >= 0) & mask[..., None]).sum()),
                "visible_lights": int(valid.sum())}

    def render(self, pose: dict, prev_avg: float, delta_time: float):
        """-> (uint8 (H, W, 3), new average luminance (0-d), counts)."""
        cfg, dev = self.cfg, self.dev
        w, h = cfg["width"], cfg["height"]
        fov, near, far = cfg["fov"], cfg["near"], cfg["far"]
        cam, setup, tri_id, depth, tris, rows, valid = self._visible(pose)
        vattr = self.vattr[tris]
        gb_a, gb_b, gb_c, mask = shade.gbuffer(tri_id, setup.edges, vattr, self.material,
                                               self.albedo)
        hdr, pairs = shade.deferred(gb_a, gb_b, gb_c, depth, mask, cam, rows, self.ibl, fov,
                                    near, far, self.dtype)
        hdr = post.bloom(hdr)
        prev = torch.as_tensor(prev_avg, dtype=torch.float32, device=dev)
        avg = post.exposure(post.luminance_sums(hdr), float(w * h), prev, delta_time)
        counts = {"pixels": w * h, "covered": int(mask.sum()), "lit_pairs": pairs,
                  "lights": int(rows.shape[0]), "visible_lights": int(valid.sum())}
        return post.present(hdr, avg), avg, counts


def attenuation(radius: float) -> np.ndarray:
    """(radius, kc, kl, kq) of a point light of `radius` (OGRE presets)."""
    presets = np.array(
        [[0.1, 1.0, 45.0, 7500.0], [1.0, 1.0, 4.5, 75.0], [7.0, 1.0, 0.7, 1.8],
         [13.0, 1.0, 0.35, 0.44], [20.0, 1.0, 0.22, 0.2], [32.0, 1.0, 0.14, 0.07],
         [50.0, 1.0, 0.09, 0.032], [65.0, 1.0, 0.07, 0.017], [100.0, 1.0, 0.045, 0.0075],
         [160.0, 1.0, 0.027, 0.0028], [200.0, 1.0, 0.022, 0.0019], [325.0, 1.0, 0.014, 0.0007],
         [600.0, 1.0, 0.007, 0.0002]], dtype=np.float32)
    for p in presets[:-1]:
        if radius < p[0]:
            return np.array([radius, p[1], p[2], p[3]], np.float32)
    return presets[-1].copy()
