"""Asset-import console commands — counterpart of `app/console.py`.

The reference runs a blocking stdin console on a worker thread
(`Utils/ConsoleCommand.h:88-132`, commands listed in `Command.txt`); here the
same five commands are exposed both as an argparse CLI
(`python -m direct12pbrrenderer_tpu_torch.app.console <command> ...`) and as
an interactive REPL (`... console repl`), dispatching to the port's
ResourceLoader importers:

  ImportModel          -i model.obj -o Asset/Model/X/X [-s scale] [-f]
  ImportTexture        -i image.png -o Asset/Model/X/tex
  ImportCubeMap        -i folder_with_px..nz.hdr -o Asset/SkyBox/Name
  CreateSphereModel    -o Asset/Model/Sphere
  GenerateIrradianceMap -i Asset/SkyBox/Name -o folder [-s size]

plus one extra over the reference: `CreateProceduralSky` synthesizes an HDR
sky cubemap (gradient + sun) and stores it with its SH baked. Every command
writes the same files, byte for byte, as the JAX package's console. In the
REPL a line that is not a command, `repl` included, prints "bad command"
(the JAX console raises on a nested `repl`)."""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np

from ..ops.common import cubemap_face_dirs
from ..resource import bc
from ..resource.default_meshes import sphere_mesh
from ..resource.formats import ETextureFormat
from ..resource.hdr import save_hdr
from ..resource.loader import ResourceLoader, generate_data_path
from ..resource.resources import CubeMapResource, MaterialResource, MeshResource, ModelResource
from ..resource.storage import CubeMapTextureData, TextureData
from ..utils import sh as sh_mod


def import_model(loader: ResourceLoader, args) -> str:
    model = loader.import_model(args.input, args.output, scale=args.scale,
                                flip_uv_y=args.flip_uv)
    return f"imported model -> {model.repo_path}" if model else "import failed"


@contextlib.contextmanager
def _hdr_quality(args):
    """Context: BC6H encode quality for this import (--hdr-quality)."""
    prev = bc.BC6H_QUALITY_DEFAULT
    bc.BC6H_QUALITY_DEFAULT = getattr(args, "hdr_quality", prev)
    try:
        yield
    finally:
        bc.BC6H_QUALITY_DEFAULT = prev


def import_texture(loader: ResourceLoader, args) -> str:
    with _hdr_quality(args):
        tex = loader.import_texture(args.input, args.output)
    return f"imported texture -> {tex.repo_path}" if tex else "import failed"


def import_cubemap(loader: ResourceLoader, args) -> str:
    with _hdr_quality(args):
        res = loader.import_cubemap(args.input, args.output)
    return f"imported cubemap -> {res.repo_path}"


def create_sphere_model(loader: ResourceLoader, args) -> str:
    """CreateStandardSphereModel (ResourceLoader.cpp:301-323)."""
    base = args.output
    mesh_path = f"{base}/sphere_Mesh"
    mesh = sphere_mesh(1.0, 32, 24)
    data_path = generate_data_path(mesh_path)
    loader.dump_binary(mesh, data_path)
    mesh_res = MeshResource(mesh_path, data_path)
    mesh_res.mesh = mesh
    loader.dump_resource(mesh_res)
    mat = MaterialResource(f"{base}/sphere_Mat")
    mat.set_shader("gbuffer.hlsl")
    loader.dump_resource(mat)
    model = ModelResource(f"{base}/sphere_Model", mesh_res, [mat])
    loader.dump_resource(model)
    return f"created {model.repo_path}"


def generate_irradiance_map(loader: ResourceLoader, args) -> str:
    """SH-irradiance debug dump (ConsoleCommand.cpp:12-50): evaluates the
    baked SH of a cubemap over a small cubemap and writes the faces as .hdr."""
    res = loader.load_resource(CubeMapResource, args.input)
    faces = sh_mod.generate_irradiance_map(res.cubemap, args.size)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    names = ["px", "nx", "py", "ny", "pz", "nz"]
    for i, n in enumerate(names):
        save_hdr(out / f"{n}.hdr", faces[i])
    return f"wrote 6 x {args.size}^2 irradiance faces to {out}"


def create_procedural_sky(loader: ResourceLoader, args) -> str:
    """Synthesize an HDR sky cubemap (horizon gradient + sun disc) and store
    it as a CubeMapResource with baked SH."""
    size = args.size
    dirs = cubemap_face_dirs(size)  # (6, s, s, 3)
    y = dirs[..., 1:2]
    horizon = np.array([0.35, 0.45, 0.65], np.float32)
    zenith = np.array([0.08, 0.18, 0.45], np.float32)
    ground = np.array([0.25, 0.22, 0.18], np.float32)
    t = np.clip(y, 0, 1) ** 0.6
    sky = horizon * (1 - t) + zenith * t
    sky = np.where(y < 0, ground * (1 + y), sky).astype(np.float32)
    sun_dir = np.array(args.sun_dir, np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    cos = (dirs * sun_dir).sum(-1, keepdims=True)
    sky = sky + np.exp((cos - 1.0) * 800.0) * args.sun_intensity
    sky = sky.astype(np.float32)

    faces = [
        TextureData.from_array(
            np.concatenate([sky[i], np.ones_like(sky[i][..., :1])], -1),
            ETextureFormat.R32G32B32A32_FLOAT,
        )
        for i in range(6)
    ]
    cube = CubeMapTextureData(faces=faces)
    data_path = generate_data_path(args.output)
    loader.dump_binary(cube, data_path)
    res = CubeMapResource(args.output, data_path)
    res.cubemap = cube
    loader.dump_resource(res)
    return f"created procedural sky -> {res.repo_path} (SH baked)"


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(prog="console")
    ap.add_argument("--asset-root", default=".")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("ImportModel")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-s", "--scale", type=float, default=1.0)
    p.add_argument("-f", "--flip-uv", action="store_true")
    p.set_defaults(fn=import_model)

    p = sub.add_parser("ImportTexture")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--hdr-quality", choices=("fast", "high"), default="fast",
                   help="BC6H encode: fast=mode 11, high=multi-mode search")
    p.set_defaults(fn=import_texture)

    p = sub.add_parser("ImportCubeMap")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--hdr-quality", choices=("fast", "high"), default="fast",
                   help="BC6H encode: fast=mode 11, high=multi-mode search")
    p.set_defaults(fn=import_cubemap)

    p = sub.add_parser("CreateSphereModel")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=create_sphere_model)

    p = sub.add_parser("GenerateIrradianceMap")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-s", "--size", type=int, default=64)
    p.set_defaults(fn=generate_irradiance_map)

    p = sub.add_parser("CreateProceduralSky")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-s", "--size", type=int, default=256)
    p.add_argument("--sun-dir", type=float, nargs=3, default=(0.4, 0.6, 0.3))
    p.add_argument("--sun-intensity", type=float, default=80.0)
    p.set_defaults(fn=create_procedural_sky)

    sub.add_parser("repl")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    loader = ResourceLoader.set_instance(ResourceLoader(args.asset_root))
    if args.command == "repl":
        print("console ready (ImportModel/ImportTexture/ImportCubeMap/"
              "CreateSphereModel/GenerateIrradianceMap/CreateProceduralSky; quit to exit)")
        for line in sys.stdin:
            line = line.strip()
            if line in ("quit", "exit", ""):
                if line:
                    break
                continue
            try:
                sub_args = ap.parse_args([f"--asset-root={args.asset_root}"] + line.split())
            except SystemExit:  # argparse has printed the usage error
                print("bad command")
                continue
            if sub_args.command == "repl":
                print("bad command")
                continue
            print(sub_args.fn(loader, sub_args))
        return
    print(args.fn(loader, args))


if __name__ == "__main__":
    main()
