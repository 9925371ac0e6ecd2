"""The G-buffer (gbuffer.hlsl's pixel stage) and the deferred lighting
(deferred_shading.hlsl, clustered_culling.hlsl, skybox.hlsl)."""

from __future__ import annotations

import math

import torch

from .ibl import EPS, PI, normalize
from .texture import MipTexture, sample_2d_clamp

INV_PI = 0.31830988618
CLUSTERS = (24, 16, 8)
PER_CLUSTER = 32
CULL_COEF = 1.814


def q8(x):
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) * (1.0 / 255.0)


def gamma_decode(c):
    return torch.pow(torch.clamp(c, min=0.0), 2.2)


def nz_sign(x):
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def oct_encode(d):
    d = d / d.abs().sum(-1, keepdim=True)
    xy = d[..., :2]
    folded = nz_sign(xy) * torch.stack([1.0 - d[..., 1].abs(), 1.0 - d[..., 0].abs()], -1)
    return torch.where(d[..., 2:3] < 0, folded, xy) * 0.5 + 0.5


def oct_decode(uv):
    xy = uv * 2.0 - 1.0
    z = 1.0 - xy[..., 0].abs() - xy[..., 1].abs()
    folded = nz_sign(xy) * torch.stack([1.0 - xy[..., 1].abs(), 1.0 - xy[..., 0].abs()], -1)
    xy = torch.where((z < 0)[..., None], folded, xy)
    d = torch.cat([xy, z[..., None]], -1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def quad_derivatives(img):
    """Hardware-like ddx/ddy: both pixels of a 2x2 quad share a difference."""
    h, w = img.shape[0], img.shape[1]
    px = img.reshape(h, w // 2, 2, -1)
    ddx = (px[:, :, 1] - px[:, :, 0])[:, :, None, :].expand(px.shape).reshape(img.shape)
    py = img.reshape(h // 2, 2, w, -1)
    ddy = (py[:, 1] - py[:, 0])[:, None, :, :].expand(py.shape).reshape(img.shape)
    return ddx, ddy


def gbuffer(tri_id, edges, vattr, material: dict, albedo_map: MipTexture | None):
    """(A (H, W, 4) albedo + emission, B (H, W, 2) octahedral normal,
    C (H, W, 3) roughness, metallic, ao; each RGBA8-quantized, 0 off the
    geometry) from the id buffer, the triangles' edge rows (T, 3, 3) and
    their vertices' (uv, normal, tangent) rows (T, 3, 8)."""
    h, w = tri_id.shape
    dev = tri_id.device
    mask = tri_id >= 0
    tid = torch.clamp(tri_id, min=0).long()
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None]
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
    px, py = torch.broadcast_tensors(px, py)
    e = edges[tid]
    b = [(px * e[..., i, 0] + py * e[..., i, 1]) + e[..., i, 2] for i in range(3)]
    sum_b = (b[0] + b[1]) + b[2]
    d = torch.where(sum_b == 0, 1.0, sum_b)
    lam = torch.stack([bi / d for bi in b], -1)
    wt = vattr[tid] * lam[..., None]
    interp = torch.where(mask[..., None], (wt[..., 0, :] + wt[..., 1, :]) + wt[..., 2, :], 0.0)
    uv = interp[..., 0:2]
    nrm = normalize(interp[..., 2:5], 1e-20)
    if material["albedo_map"]:
        ddx, ddy = quad_derivatives(uv)
        size = torch.tensor(albedo_map.size, device=dev)
        gx, gy = ddx * size, ddy * size
        rho2 = torch.maximum((gx * gx).sum(-1), (gy * gy).sum(-1))
        lod = torch.where(mask, 0.5 * torch.log2(torch.clamp(rho2, min=1e-12)), 99.0)
        albedo = gamma_decode(albedo_map.trilinear(uv[..., 0], uv[..., 1], lod)[..., :3])
    else:
        albedo = gamma_decode(torch.as_tensor(material["albedo"], device=dev)).expand(h, w, 3)
    em = torch.full((h, w, 1), float(material["emission"]), device=dev)
    rm = torch.tensor([material["roughness"], material["metallic"], 0.0],
                      dtype=torch.float32, device=dev).expand(h, w, 3)
    m = mask[..., None]
    return (torch.where(m, q8(torch.cat([albedo, em], -1)), 0.0),
            torch.where(m, q8(oct_encode(nrm)), 0.0), torch.where(m, q8(rm), 0.0), mask)


def camera_rays(h, w, inv_view, fov, ratio, near):
    dev = inv_view.device
    near_h = 2.0 * near * torch.tan(torch.tensor(fov / 2.0, dtype=torch.float32, device=dev))
    near_w = near_h * ratio
    v = ((torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h)[:, None]
    u = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w)[None, :]
    u, v = torch.broadcast_tensors(u, v)
    cam = torch.stack([(u - 0.5) * near_w, (0.5 - v) * near_h, torch.full_like(u, near)], -1)
    return (cam[..., None, :] * inv_view[:3, :3]).sum(-1)


def light_rows(lights: dict, valid, view, device) -> torch.Tensor:
    """(n, 14) rows [pos(3), color(3), intensity, kc, kl, kq, view pos(3),
    cull radius] of the visible lights, in light order."""
    pos = torch.as_tensor(lights["translation"], device=device)
    att = torch.as_tensor(lights["attenuation"], device=device)
    inten = torch.as_tensor(lights["intensity"], dtype=torch.float32, device=device)
    ph = torch.cat([pos, torch.ones_like(pos[:, :1])], -1)
    pv = (ph[:, None, :] * view[None]).sum(-1)[:, :3]
    cull = att[:, 0] * CULL_COEF * torch.sqrt(torch.clamp(inten, min=0.0))
    rows = torch.cat([pos, torch.as_tensor(lights["color"], device=device), inten[:, None],
                      att[:, 1:4], pv, cull[:, None]], 1)
    return rows[valid]


def cluster_of(z_view, h, w, near, far):
    """Each pixel's cluster (sx, sy, sz) as float tensors (clustered.hlsli)."""
    cx, cy, cz = CLUSTERS
    dev = z_view.device
    u = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5) / h
    sx = torch.clamp(torch.floor(u * cx), 0, cx - 1).expand(z_view.shape)
    sy = torch.clamp(torch.floor((1.0 - v) * cy), 0, cy - 1).expand(z_view.shape)
    zc = torch.clamp(z_view, near, far)
    sz = torch.clamp(torch.floor(cz * torch.log(zc / near) / math.log(far / near)), 0, cz - 1)
    return sx, sy, sz


def cluster_lists(rows, fov, ratio, near, far):
    """(clusters, 32) light rows' indices, -1 padded: each cluster's first 32
    lights, in light order, whose culling sphere meets its view-space AABB;
    and the (clusters,) count of lights that met it."""
    cx, cy, cz = CLUSTERS
    dev = rows.device
    g = torch.arange(cx * cy * cz, device=dev)
    sx = (g // (cy * cz)).float()
    sy = ((g // cz) % cy).float()
    sz = (g % cz).float()
    tan_half = math.tan(fov / 2.0)
    zn = near * torch.pow(far / near, sz / cz)
    zf = near * torch.pow(far / near, (sz + 1) / cz)
    x0, y0 = 2.0 * sx / cx - 1.0, 2.0 * sy / cy - 1.0
    x1, y1 = 2.0 * (sx + 1) / cx - 1.0, 2.0 * (sy + 1) / cy - 1.0
    xs = [x0 * ratio * tan_half * zn, x0 * ratio * tan_half * zf,
          x1 * ratio * tan_half * zn, x1 * ratio * tan_half * zf]
    ys = [y0 * tan_half * zn, y0 * tan_half * zf, y1 * tan_half * zn, y1 * tan_half * zf]
    cmin = torch.stack([torch.minimum(torch.minimum(xs[0], xs[1]), torch.minimum(xs[2], xs[3])),
                        torch.minimum(torch.minimum(ys[0], ys[1]), torch.minimum(ys[2], ys[3])),
                        zn], -1)
    cmax = torch.stack([torch.maximum(torch.maximum(xs[0], xs[1]), torch.maximum(xs[2], xs[3])),
                        torch.maximum(torch.maximum(ys[0], ys[1]), torch.maximum(ys[2], ys[3])),
                        zf], -1)
    pv, r = rows[None, :, 10:13], rows[None, :, 13]
    closest = torch.minimum(torch.maximum(pv, cmin[:, None]), cmax[:, None])
    dd = (pv - closest) ** 2
    hit = ((dd[..., 0] + dd[..., 1]) + dd[..., 2]) < r * r
    pos = torch.cumsum(hit, 1) - 1
    keep = hit & (pos < PER_CLUSTER)
    lists = torch.full((len(g), PER_CLUSTER + 1), -1, dtype=torch.long, device=dev)
    idx = torch.arange(rows.shape[0], device=dev).expand(hit.shape)
    lists.scatter_(1, torch.where(keep, pos, PER_CLUSTER), torch.where(keep, idx, -1))
    return lists[:, :PER_CLUSTER], hit.sum(1)


def cook_torrance(albedo, metallic, roughness, normal, view_dir, ldir):
    half = normalize(ldir + view_dir, EPS)
    n_dot_l = torch.clamp((normal * ldir).sum(-1), min=0.0)
    n_dot_v = torch.clamp((normal * view_dir).sum(-1), min=0.0)
    n_dot_h = torch.clamp((normal * half).sum(-1), min=0.0)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    f = f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - n_dot_l[..., None], min=EPS), 5.0)
    a = roughness * roughness
    t = (n_dot_h * n_dot_h) * (a * a - 1.0) + 1.0
    d = a * a / torch.clamp(PI * t * t, min=EPS)
    k = (roughness + 1.0) ** 2 / 8.0
    g = (n_dot_v / torch.clamp(n_dot_v * (1.0 - k) + k, min=EPS)) * (
        n_dot_l / torch.clamp(n_dot_l * (1.0 - k) + k, min=EPS))
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    spec = f * (d * g / torch.clamp(4.0 * n_dot_l * n_dot_v, min=1e-4))[..., None]
    return kd * albedo * INV_PI + spec


def deferred(gb_a, gb_b, gb_c, depth, mask, cam: dict, rows, ibl: dict, fov, near, far,
             dtype=torch.float32):
    """(H, W, 3) HDR radiance and the pixels' (lit pixel, light) pair count.
    `dtype` is the type the lighting is computed in (the control runs it in
    bfloat16)."""
    h, w = depth.shape
    dev = depth.device
    ratio = w / h
    inv_view, cam_pos = cam["inv_view"], cam["position"]
    albedo = gb_a[..., :3]
    emission = gb_a[..., 3]
    normal = oct_decode(gb_b)
    rough, metal = gb_c[..., 0], gb_c[..., 1]
    rays = camera_rays(h, w, inv_view, fov, ratio, near)
    z_view = near * far / (far - depth * (far - near))
    position = cam_pos + rays * (z_view / near)[..., None]
    view_dir = normalize(cam_pos - position, 1e-20)
    ndv = (normal * view_dir).sum(-1)
    n_dot_v = torch.clamp(ndv, min=0.0)
    refl = normalize(2.0 * ndv[..., None] * normal - view_dir, 1e-20)
    ray = normalize(rays, 1e-20)

    sh = ibl["sh"]
    n = normal
    a4 = torch.cat([n, torch.ones_like(n[..., :1])], -1)
    b4 = torch.stack([n[..., 0] * n[..., 1], n[..., 1] * n[..., 2], n[..., 2] * n[..., 2],
                      n[..., 2] * n[..., 0]], -1)
    c1 = n[..., 0] * n[..., 0] - n[..., 1] * n[..., 1]
    l2 = torch.stack([(b4 * sh[i]).sum(-1) for i in (1, 3, 5)], -1) + sh[6, :3] * c1[..., None]
    irr = torch.stack([(a4 * sh[i]).sum(-1) for i in (0, 2, 4)], -1) + l2
    env = ibl["prefiltered"].trilinear(refl, rough * 5.0)[..., :3]
    lut = sample_2d_clamp(ibl["lut"], rough, n_dot_v)

    ct = dtype
    albedo_t, metal_t, rough_t = albedo.to(ct), metal.to(ct), rough.to(ct)
    kd = albedo_t * (1.0 - metal_t[..., None]) * INV_PI
    f0 = 0.04 * (1.0 - metal_t[..., None]) + albedo_t * metal_t[..., None]
    lit = kd * irr.to(ct) + env.to(ct) * (f0 * lut[..., 0:1].to(ct) + lut[..., 1:2].to(ct))

    lists, _ = cluster_lists(rows, fov, ratio, near, far)
    sx, sy, sz = cluster_of(z_view, h, w, near, far)
    cid = ((sx * CLUSTERS[1] + sy) * CLUSTERS[2] + sz).long()
    mine = lists[cid]                                  # (H, W, 32)
    pairs = int(((mine >= 0) & mask[..., None]).sum())
    normal_t, view_t, pos_t = normal.to(ct), view_dir.to(ct), position.to(ct)
    rows_t = rows.to(ct)
    acc = torch.zeros((h, w, 3), dtype=ct, device=dev)
    for j in range(PER_CLUSTER):
        s = mine[..., j]
        on = s >= 0
        if not bool(on.any()):
            break
        lp = rows_t[torch.clamp(s, min=0)]
        ldir = lp[..., 0:3] - pos_t
        dist = torch.linalg.vector_norm(ldir, dim=-1)
        ldir = ldir / torch.clamp(dist[..., None], min=1e-20)
        n_dot_l = torch.clamp((normal_t * ldir).sum(-1), min=0.0)
        att = 1.0 / torch.clamp(lp[..., 7] + lp[..., 8] * dist + lp[..., 9] * dist * dist,
                                min=EPS)
        f = cook_torrance(albedo_t, metal_t, rough_t, normal_t, view_t, ldir)
        acc = acc + torch.where(on[..., None], f * (lp[..., 3:6] * (lp[..., 6] * att * n_dot_l)
                                                    [..., None]), 0.0)
    lit = (lit + acc + albedo_t * emission.to(ct)[..., None]).float()
    sky = ibl["sky"].bilinear(ray, torch.zeros((h, w), dtype=torch.long, device=dev))[..., :3]
    return torch.where(mask[..., None], lit, sky), pairs
