"""The port's asset-tree loading against the JAX package's, on the CPU.

* One set of source files (an OBJ/MTL quad with a PNG map, six HDR cube
  faces) imported by each package's own importers into its own tree, plus a
  Scene JSON each: the two trees hold the same files with the same bytes.
  Each package loads the other's tree, and the meshes, texture mips, cube
  faces (BC payloads decoded) and SH packs equal the writer's own load.
* JSON and binary (de)serialization of a Scene, a mesh, a texture and a
  cubemap in memory: identical bytes in both directions.
* The imported quad scene rendered by the port from the JAX package's tree
  and by the JAX package from the port's tree, on the plain path: within 1
  LSB and rmse 1e-3 (the JAX package's frame bar; test_torch_pipeline.py),
  with equal FrameStats.
* BC1 and BC6H: the port's numpy codec equal to the JAX package's on
  random blocks and images (both directions, both BC6H qualities); the
  native codec equal to the numpy one (as test_native.py); the BC6H
  reference vectors of tests/data/bc6h_vectors.npz through both decoders.
* `save_hdr`/`load_hdr`, TLSF and the loose octree (mirroring
  test_native.py), the thread pool and misc (mirroring
  test_utils_host.py), `Scene.cull_models`/`cull_lights`/`mesh_count`.
* A missing blob degrades as in the JAX package, and the native build run
  by two processes at once compiles once and both load; a failing compiler
  raises.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.resource import bc as jbc
from direct12pbrrenderer_tpu.resource import hdr as jhdr
from direct12pbrrenderer_tpu.resource import loader as jloader
from direct12pbrrenderer_tpu.resource import storage as jstorage
from direct12pbrrenderer_tpu_torch.resource import bc, hdr, loader, native_codec, storage
from direct12pbrrenderer_tpu_torch.resource.formats import ETextureFormat

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"jax": "direct12pbrrenderer_tpu", "port": "direct12pbrrenderer_tpu_torch"}


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def _write_sources(src):
    """The quad of test_import_e2e.py (OBJ/MTL, a 16x16 PNG map for two
    slots) and six 16x16 HDR cube faces."""
    from PIL import Image

    rng = np.random.default_rng(0)
    src.mkdir()
    Image.fromarray(rng.integers(0, 255, (16, 16, 3), np.uint8)).save(src / "checker.png")
    (src / "quad.mtl").write_text("newmtl quadmat\nmap_Kd checker.png\nmap_Pr checker.png\n")
    (src / "quad.obj").write_text(
        "mtllib quad.mtl\nv -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nvn 0 0 -1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl quadmat\nf 4/4/1 3/3/1 2/2/1 1/1/1\n")
    cube = src / "cube"
    cube.mkdir()
    g = np.linspace(0.2, 4.0, 16, dtype=np.float32)
    for i, name in enumerate(("px", "nx", "py", "ny", "pz", "nz")):
        face = np.stack([np.tile(g, (16, 1)), np.tile(g[:, None], (1, 16)),
                         np.full((16, 16), 0.5 + 0.25 * i)], -1).astype(np.float32)
        jhdr.save_hdr(cube / f"{name}.hdr", face)


def _import_tree(pkg, src, root):
    """Import the sources with package `pkg`'s importers into `root`, with
    a Scene JSON (the quad, one light, the sky); returns the loader."""
    ld_mod = _mod(pkg, "resource.loader")
    scene_mod = _mod(pkg, "scene.scene")
    ld = ld_mod.ResourceLoader.set_instance(ld_mod.ResourceLoader(root))
    ld.import_model(src / "quad.obj", "Asset/Quad/Quad", scale=2.0)
    ld.import_cubemap(src / "cube", "Asset/Sky/Faces")
    scene = scene_mod.Scene("Asset/Scene/main")
    sm = scene_mod.SceneModel("quad")
    sm.model_file_path = "Asset/Quad/Quad_Model"
    sm.translation = np.array([0.0, 0.0, 0.5], np.float32)
    scene.add_model(sm)
    light = scene_mod.SceneLight("key")
    light.translation = np.array([0.5, 0.5, -2.0], np.float32)
    light.set_intensity(30.0)
    scene.add_light(light)
    scene.skybox_path = "Asset/Sky/Faces"
    ld.dump_resource(scene)
    return ld


@pytest.fixture
def trees(tmp_path):
    """(source dir, JAX tree, port tree); both loader singletons restored."""
    old = (jloader.ResourceLoader._instance, loader.ResourceLoader._instance)
    src = tmp_path / "src"
    _write_sources(src)
    _import_tree("jax", src, tmp_path / "jax")
    _import_tree("port", src, tmp_path / "port")
    yield src, tmp_path / "jax", tmp_path / "port"
    jloader.ResourceLoader._instance, loader.ResourceLoader._instance = old


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _load_scene(pkg, root):
    ld_mod = _mod(pkg, "resource.loader")
    ld = ld_mod.ResourceLoader.set_instance(ld_mod.ResourceLoader(root))
    return ld.load_resource(_mod(pkg, "scene.scene").Scene, "Asset/Scene/main")


def _scene_arrays(scene):
    model = scene.models[0].model
    mat = model.materials[0]
    cube = scene.skybox.cubemap
    return {
        "vertices": model.mesh_resource.mesh.vertex_array().tobytes(),
        "indices": np.asarray(model.mesh_resource.mesh.index_array()).tobytes(),
        "albedo": mat.textures["AlbedoMap"].texture.mip_array_rgba(0).tobytes(),
        "albedo_mip2": mat.textures["AlbedoMap"].texture.mip_array_rgba(2).tobytes(),
        "flags": json.dumps(mat.parameter_table, sort_keys=True, default=str),
        "faces": cube.face_arrays(0).tobytes() + cube.face_arrays(2).tobytes(),
        "sh": np.asarray(scene.skybox.sh.as_array()).tobytes(),
        "world": scene.models[0].world_matrix.tobytes(),
        "light": scene.lights[0].attenuation.tobytes(),
    }


def test_trees_identical_and_cross_load(trees):
    _, jroot, troot = trees
    jfiles, tfiles = _files(jroot), _files(troot)
    assert sorted(jfiles) == sorted(tfiles)
    assert {k for k in jfiles if k.endswith(".bin")} >= {
        "Asset/Quad/Quad_Mesh_data.bin", "Asset/Sky/Faces_data.bin"}
    for name in jfiles:
        assert jfiles[name] == tfiles[name], name
    want = _scene_arrays(_load_scene("jax", jroot))
    for pkg, root in (("port", jroot), ("jax", troot), ("port", troot)):
        got = _scene_arrays(_load_scene(pkg, root))
        for k in want:
            assert got[k] == want[k], (pkg, str(root), k)


def test_in_memory_serialization_bytes_identical(trees):
    _, jroot, troot = trees
    for pkg_w, root in (("jax", jroot), ("port", troot)):
        scenes = {pkg: _load_scene(pkg, root) for pkg in PACKAGES}
        ser = {pkg: _mod(pkg, "resource.serialization") for pkg in PACKAGES}
        dumps = {pkg: json.dumps(ser[pkg].json_serialize(scenes[pkg]), indent=4,
                                 sort_keys=True) for pkg in PACKAGES}
        assert dumps["jax"] == dumps["port"]
        back = {pkg: json.dumps(ser[pkg].json_serialize(ser[pkg].json_deserialize(
            _mod(pkg, "scene.scene").Scene, json.loads(dumps[other]))), indent=4,
            sort_keys=True) for pkg, other in (("jax", "port"), ("port", "jax"))}
        assert back["jax"] == back["port"] == dumps["jax"]
        for pick in (lambda s: s.models[0].model.mesh_resource.mesh,
                     lambda s: s.models[0].model.materials[0].textures["AlbedoMap"].texture,
                     lambda s: s.skybox.cubemap):
            blobs = {}
            for pkg in PACKAGES:
                out = bytearray()
                ser[pkg].binary_serialize(pick(scenes[pkg]), out)
                blobs[pkg] = bytes(out)
            assert blobs["jax"] == blobs["port"]
            # each package re-reads the other's bytes to the same bytes
            for pkg, other in (("jax", "port"), ("port", "jax")):
                obj = ser[pkg].binary_deserialize(type(pick(scenes[pkg])),
                                                  ser[pkg].Reader(blobs[other]))
                out = bytearray()
                ser[pkg].binary_serialize(obj, out)
                assert bytes(out) == blobs[other]


def test_imported_quad_renders_equal_across_packages(trees):
    _, jroot, troot = trees
    from direct12pbrrenderer_tpu.config import RenderConfig as JConfig
    from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JPipe
    from direct12pbrrenderer_tpu.scene.camera import Camera as JCamera
    from direct12pbrrenderer_tpu_torch.config import RenderConfig
    from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer_tpu_torch.scene.camera import Camera

    knobs = dict(tile_h=12, tile_w=64, bin_cap=128, prefilter_size=8, brdf_lut_size=16)
    frames, stats = {}, {}
    for pkg, root, cfg_cls, cam_cls in (("port", jroot, RenderConfig, Camera),
                                        ("jax", troot, JConfig, JCamera)):
        scene = _load_scene(pkg, root)
        cfg = cfg_cls(width=64, height=48, max_triangles=64, max_vertices=64,
                      max_instances=2, max_lights=4)
        if pkg == "port":
            pipe = DeferredRenderPipeline(scene, cfg, device="cpu", **knobs)
        else:
            pipe = JPipe(scene, cfg, **knobs)
        assert not pipe.use_pallas and not pipe.use_tex_kernel
        cam = cam_cls(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
        cam.move([0, 0, -3])
        frames[pkg] = np.asarray(pipe.render(cam)).astype(np.int64)
        stats[pkg] = pipe.last_stats
    assert frames["port"][18:30, 24:40].mean() > 3         # the textured quad is lit
    assert np.abs(frames["port"] - frames["jax"]).max() <= 1
    rmse = np.sqrt(np.mean((frames["port"] / 255.0 - frames["jax"] / 255.0) ** 2))
    assert rmse <= 1e-3
    assert vars(stats["port"]) == vars(stats["jax"])


def test_missing_blobs_degrade_as_in_jax(trees):
    """A material skips a texture whose blob is missing and clears its flag,
    a skybox whose blob is missing is None, a model whose mesh blob is
    missing is unloaded; a direct load of that model still raises. One JAX
    quirk is not kept: both of the quad's maps name one texture, and the
    JAX loader caches that texture's descriptor before its blob raises, so
    its second map finds the half-loaded texture in the cache and keeps it
    (flag on, no payload). The port skips both maps."""
    _, jroot, troot = trees
    for root in (jroot, troot):
        (root / "Asset/Quad/Quad_checker_data.bin").unlink()   # both maps' blob
        (root / "Asset/Sky/Faces_data.bin").unlink()
    jscene, tscene = _load_scene("jax", jroot), _load_scene("port", troot)
    jmat, tmat = (s.models[0].model.materials[0] for s in (jscene, tscene))
    assert "AlbedoMap" not in jmat.textures and jmat.parameter_table["UseAlbedoMap"] is False
    assert jmat.textures["RoughnessMap"].texture is None           # the quirk
    assert tmat.textures == {}
    assert tmat.parameter_table["UseAlbedoMap"] is tmat.parameter_table[
        "UseRoughnessMap"] is False
    assert jscene.skybox is None and tscene.skybox is None
    for root in (jroot, troot):
        (root / "Asset/Quad/Quad_Mesh_data.bin").unlink()
    jscene, tscene = _load_scene("jax", jroot), _load_scene("port", troot)
    assert jscene.models[0].model is None and tscene.models[0].model is None
    ld = loader.ResourceLoader(troot)
    from direct12pbrrenderer_tpu_torch.resource.resources import ModelResource

    assert ld.missing_file(ModelResource, "Asset/Quad/Quad_Model") == (
        troot / "Asset/Quad/Quad_Mesh_data.bin")
    with pytest.raises(FileNotFoundError):     # a direct load still raises
        ld.load_resource(ModelResource, "Asset/Quad/Quad_Model")


def test_texture_compressed_payload_roundtrip():
    rng = np.random.default_rng(2)
    img = np.repeat(np.repeat(rng.integers(0, 255, (8, 8, 4), np.uint8), 4, 0), 4, 1)
    img[..., 3] = 255
    for fmt in (ETextureFormat.R8G8B8A8_UNORM, ETextureFormat.R8G8B8A8_UNORM_SRGB):
        tex = storage.TextureData.from_mips([img], fmt)
        jtex = jstorage.TextureData.from_mips([img], fmt)
        payload = tex.compress_payload()
        assert payload == jtex.compress_payload()
        back = storage.TextureData.from_compressed(32, 32, 1, 1, fmt, payload)
        jback = jstorage.TextureData.from_compressed(32, 32, 1, 1, fmt, payload)
        np.testing.assert_array_equal(back.mip_array(0), jback.mip_array(0))
        assert np.abs(back.mip_array(0)[..., :3].astype(int)
                      - img[..., :3].astype(int)).max() <= 8
        assert (tex.sample_nearest(0.3, 0.7) == jtex.sample_nearest(0.3, 0.7)).all()


def _hdr_image(rng, h, w):
    return np.maximum(rng.lognormal(0.0, 1.5, (h, w, 4)), 0).astype(np.float16)


def test_bc_numpy_codec_matches_jax():
    rng = np.random.default_rng(3)
    blob1 = rng.integers(0, 256, 8 * 6 * 5, np.uint8).tobytes()
    np.testing.assert_array_equal(bc.bc1_decode_mip_reference(blob1, 24, 20),
                                  jbc.bc1_decode_mip(blob1, 24, 20))
    rgba = rng.integers(0, 256, (20, 24, 4), np.uint8)
    assert bc.bc1_encode_mip(rgba) == jbc.bc1_encode_mip(rgba)
    img = _hdr_image(rng, 12, 8)
    for quality in ("fast", "high"):
        blob = bc.bc6h_encode_mip_reference(img, quality)
        assert blob == jbc.bc6h_encode_mip(img, quality)
        np.testing.assert_array_equal(bc.bc6h_decode_mip_reference(blob, 8, 12).view(np.uint16),
                                      jbc.bc6h_decode_mip(blob, 8, 12).view(np.uint16))
    # the high quality emits two-region blocks on this content
    raw = np.frombuffer(bc.bc6h_encode_mip(img, "high"), np.uint8).reshape(-1, 16)
    assert ((raw[:, 0] & 0x3) != 0x3).any()


def test_bc_native_matches_numpy():
    rng = np.random.default_rng(4)
    blob = rng.integers(0, 256, 8 * 8 * 8, np.uint8).tobytes()
    np.testing.assert_array_equal(bc.bc1_decode_mip(blob, 32, 32),
                                  bc.bc1_decode_mip_reference(blob, 32, 32))
    np.testing.assert_array_equal(native_codec.bc1_decode_mip(blob, 32, 32),
                                  bc.bc1_decode_mip_reference(blob, 32, 32))
    y, x = np.mgrid[0:8, 0:8].astype(np.float32) / 8.0
    grad = np.stack([1 + 4 * x, 0.5 + y, 2 * x * y + 0.1, np.ones_like(x)], -1).astype(
        np.float16)
    for img in (grad, _hdr_image(rng, 8, 12)):
        h, w = img.shape[:2]
        blob6 = bc.bc6h_encode_mip(img)                  # the native fast path
        assert blob6 == bc.bc6h_encode_mip_reference(img, "fast")
        np.testing.assert_array_equal(bc.bc6h_decode_mip(blob6, w, h).view(np.uint16),
                                      bc.bc6h_decode_mip_reference(blob6, w, h).view(np.uint16))


def test_bc6h_reference_vectors_both_decoders():
    data = np.load(REPO / "tests" / "data" / "bc6h_vectors.npz")
    blocks, want = data["blocks"], data["texels"]
    got = np.stack([bc._decode_bc6h_block(b) for b in blocks])
    np.testing.assert_array_equal(got, want)
    n = len(blocks)
    for dec_fn in (bc.bc6h_decode_mip, bc.bc6h_decode_mip_reference):
        dec = dec_fn(blocks.tobytes(), 4 * n, 4).astype(np.float32)
        np.testing.assert_array_equal(np.stack([dec[:, i * 4:(i + 1) * 4, :3]
                                                for i in range(n)]), want)


def test_save_and_load_hdr_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.lognormal(0.0, 2.0, (9, 14, 3)).astype(np.float32)
    img[0, 0] = 0.0
    hdr.save_hdr(tmp_path / "port.hdr", img)
    jhdr.save_hdr(tmp_path / "jax.hdr", img)
    assert (tmp_path / "port.hdr").read_bytes() == (tmp_path / "jax.hdr").read_bytes()
    got = hdr.load_hdr(tmp_path / "port.hdr")
    np.testing.assert_array_equal(got, jhdr.load_hdr(tmp_path / "port.hdr"))
    assert got.shape == img.shape and got[0, 0].max() == 0.0
    # RGBE: 8 mantissa bits under the pixel's largest channel's exponent
    assert (np.abs(got - img) <= img.max(-1, keepdims=True) * 2 ** -7).all()


def test_tlsf_alloc_free_align_oom():
    from direct12pbrrenderer_tpu_torch.utils.tlsf import TlsfAllocator

    t = TlsfAllocator(1 << 20, min_block=256)
    a, b, c = t.alloc(1000), t.alloc(2000), t.alloc(4000)
    assert len({a, b, c}) == 3 and t.used >= 7000
    assert t.free(b) and t.free(a) and t.free(c) and t.used == 0
    assert t.alloc((1 << 20) - 256, align=256) is not None
    t = TlsfAllocator(1 << 20, min_block=256)
    t.alloc(300)
    for align in (512, 4096, 65536):
        off = t.alloc(1234, align=align)
        assert off is not None and off % align == 0
    t = TlsfAllocator(4096, min_block=256)
    assert t.alloc(8192) is None
    a = t.alloc(4096)
    assert a == 0 and t.alloc(256) is None
    t.free(a)
    assert t.alloc(256) is not None


def test_octree_cull_update_remove():
    from direct12pbrrenderer_tpu_torch.utils import mathlib as ml
    from direct12pbrrenderer_tpu_torch.utils.octree import LooseOctree

    rng = np.random.default_rng(1)
    tree = LooseOctree([-500] * 3, [500] * 3)
    centers = rng.uniform(-100, 100, (200, 3)).astype(np.float32)
    sizes = rng.uniform(0.5, 5, (200, 1)).astype(np.float32)
    mins, maxs = centers - sizes, centers + sizes
    handles = [tree.add(mins[i], maxs[i]) for i in range(200)]
    assert tree.node_count > 1
    planes = ml.frustum_planes_from_matrix(ml.projection_matrix1(1.0, 1.5, 0.1, 500.0))
    expected = np.nonzero(ml.frustum_cull_aabbs(planes, mins, maxs))[0]
    assert set(tree.frustum_cull(planes).tolist()) == {handles[i] for i in expected}
    tree = LooseOctree([-500] * 3, [500] * 3)
    h = tree.add([-1, -1, 10], [1, 1, 12])
    planes = ml.frustum_planes_from_matrix(ml.projection_matrix1(1.0, 1.0, 0.1, 500.0))
    assert tree.frustum_cull(planes).tolist() == [h]
    tree.update(h, [-1, -1, -12], [1, 1, -10])
    assert tree.frustum_cull(planes).size == 0
    tree.update(h, [-1, -1, 10], [1, 1, 12])
    tree.remove(h)
    assert tree.frustum_cull(planes).size == 0


def test_thread_pool_and_task_queue():
    from direct12pbrrenderer_tpu_torch.utils.threading import TaskQueue, ThreadPool

    pool = ThreadPool(8)
    box, lock = {"v": 0}, threading.Lock()

    def bump():
        with lock:
            box["v"] += 1

    try:
        assert pool.schedule(lambda a, b: a + b, 19, 23).result(timeout=5) == 42
        futs = [pool.schedule(lambda i=i: i * i) for i in range(100)]
        futs += [pool.schedule(bump) for _ in range(50)]
        assert [f.result(timeout=10) for f in futs[:100]] == [i * i for i in range(100)]
        for f in futs[100:]:
            f.result(timeout=10)
        assert box["v"] == 50
        assert pool.map(lambda x: x + 1, [1, 2, 3]) == [2, 3, 4]
        with pytest.raises(ZeroDivisionError):
            pool.schedule(lambda: 1 / 0).result(timeout=5)
    finally:
        pool.shutdown()
    assert not any(t.is_alive() for t in pool._threads)
    q = TaskQueue()
    f1, f2 = q.schedule(lambda: "a"), q.schedule(lambda: "b")
    assert q.run_one(block=False) and q.run_one(block=False)
    assert not q.run_one(block=False) and q.empty()
    t0 = time.perf_counter()
    assert not q.run_one(block=True, timeout=0.05)           # waits, then gives up
    assert time.perf_counter() - t0 >= 0.04
    assert (f1.result(), f2.result()) == ("a", "b")


def test_misc_event_timescope_align():
    from direct12pbrrenderer_tpu_torch.utils.misc import Event, TimeScope, align_up, new_uuid

    ev, got = Event(), []
    h1 = got.append
    ev += h1
    ev += lambda x: got.append(x * 10)
    ev(3)
    assert got == [3, 30] and len(ev) == 2
    ev -= h1
    ev(4)
    assert got == [3, 30, 40]
    seen = []
    with TimeScope("x", log=lambda label, s: seen.append((label, s))) as ts:
        time.sleep(0.01)
    assert seen[0][0] == "x" and seen[0][1] == ts.elapsed >= 0.009
    assert [align_up(v, 256) for v in (0, 1, 256, 257)] == [0, 256, 256, 512]
    assert len(new_uuid()) == 32 and new_uuid() != new_uuid()


def test_scene_culling_matches_jax(trees):
    _, jroot, _ = trees
    scenes = {pkg: _load_scene(pkg, jroot) for pkg in PACKAGES}
    for s in scenes.values():
        assert s.mesh_count() == 1
    cams = {pkg: _mod(pkg, "scene.camera").Camera(1.0, 64, 48, 0.1, 100.0) for pkg in PACKAGES}
    for pkg, cam in cams.items():
        cam.move([0, 0, -3])
    for yaw in (0.0, np.pi):
        counts = {}
        for pkg, cam in cams.items():
            if yaw:
                cam.rotate(0.0, yaw, 0.0)
            planes = cam.frustum_planes()
            counts[pkg] = (len(scenes[pkg].cull_models(planes)),
                           len(scenes[pkg].cull_lights(planes)))
        assert counts["port"] == counts["jax"]
        assert counts["port"][0] == (1 if yaw == 0.0 else 0)


def test_native_build_concurrent_once_and_failure_raises(tmp_path):
    """Two processes load the native library into one empty build directory
    at once: g++ runs once and both load the same file. A failing compiler
    raises."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "gxx.log"
    real = subprocess.run(["which", "g++"], capture_output=True, text=True,
                          check=True).stdout.strip()
    (bindir / "g++").write_text(f"#!/bin/sh\necho run >> {log}\nsleep 1\nexec {real} \"$@\"\n")
    (bindir / "g++").chmod(0o755)
    code = ("import sys; from pathlib import Path; "
            "import direct12pbrrenderer_tpu_torch.native as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); lib = n.load(); "
            "print(n.library_path(), lib.tlsf_create(4096, 256) != 0)")
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
    build_dir = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0] and outs[0][0].strip().endswith("True")
    assert log.read_text().splitlines() == ["run"]
    assert [p.name for p in build_dir.glob("*.so")] == [pathlib.Path(
        outs[0][0].split()[0]).name]
    assert not list(build_dir.glob("*.tmp"))

    (bindir / "g++").write_text("#!/bin/sh\necho broken >&2\nexit 1\n")
    bad = subprocess.run([sys.executable, "-c", code, str(tmp_path / "fresh")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "RuntimeError: g++ failed" in bad.stderr
