"""Kernel D's reduced-precision light loop (`ops/shade_fused.py` with
`light_dtype`, the pipeline's `fused_light_dtype`) against the JAX
package's `shade_pallas.deferred_shade_fused(light_dtype=...)` in interpret
mode, on `test_torch_shade_fused.py`'s inputs (48x256, 40 crowded lights,
with and without env content).

The JAX reference runs in one subprocess with
`XLA_FLAGS="--xla_allow_excess_precision=false --xla_cpu_max_isa=AVX"`, set
before JAX initialises. XLA's CPU backend otherwise keeps bfloat16 chains
in float32 (27.5% of the bfloat16 frame moves between the two settings of
the first flag), and always lets LLVM fuse a product and a sum into an FMA
(float32 and float16 alike; AVX has no FMA instructions, so the second flag
stops it). The port, like the CUDA kernel (`--fmad=false`, the `_rn`
intrinsics), rounds every product and sum. Measured with both flags, the
same in both env cases (with the first flag alone, float16 was 35.3%
bit-equal, worst 4.47 float16 ulps: XLA's FMAs):

| light_dtype | values bit-equal | worst difference | bar |
|---|---|---|---|
| float32  | 73.2% | 128 float32 ulps | 256 |
| bfloat16 | 84.2% | 0.002 bfloat16 ulps | 0.004 |
| float16  | 84.2% | 0.016 float16 ulps | 0.032 |

(ulps of the type at the JAX value; the float32 geometry, env resolve and
light sums, where XLA's einsum and fusions round otherwise, are the rest.)
On the values that the type moves away from JAX's float32 run (28% of
them), the port's median difference from JAX's run of the same type is 0,
against a median of 4e-3 (bfloat16) and 1.4e-3 (float16) between JAX's
runs; a port that computes the loop in float32 fails that check.

The pipeline with `fused_light_dtype="bfloat16"` is held to the JAX
pipeline with the same knob (in process, default XLA flags) at the JAX
package's fidelity bar, rmse <= 1e-3 on uint8/255, with equal FrameStats;
any other value than None, "float32", "bfloat16" and "float16" raises
ValueError; and the band frame keeps the float32 loop, as the JAX band
frame does.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import recording
from direct12pbrrenderer_tpu.pipeline.deferred import DeferredRenderPipeline as JaxPipeline
from direct12pbrrenderer_tpu_torch.ops import shade_fused
from direct12pbrrenderer_tpu_torch.parallel import frame_sharded
from direct12pbrrenderer_tpu_torch.pipeline.deferred import DeferredRenderPipeline
from direct12pbrrenderer_tpu_torch.state import state_from_jax
from test_torch_pipeline import FUSED_KNOBS, _fused_scene, _rmse, jax_state
from test_torch_shade_fused import H, TH, TW, W, _inputs

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("float32", "bfloat16", "float16")
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}
# light_dtype -> (least share of values bit-equal, worst difference in ulps
# of the type): the measured share rounded down, twice the measured worst
BARS = {"float32": (0.73, 256.0), "bfloat16": (0.84, 0.004), "float16": (0.84, 0.032)}
RMSE_BAR = 1e-3

_JAX_SCRIPT = """
import sys
import numpy as np
import jax.numpy as jnp
from direct12pbrrenderer_tpu.ops import shade_pallas
from test_torch_shade_fused import H, TH, TW, W, _inputs

out = {}
for has_env in (True, False):
    d = _inputs(5, has_env)
    cfg = d["cfg"]
    out[f"active_{has_env}"] = d["active"]
    for ld in ("float32", "bfloat16", "float16"):
        rt, approx = shade_pallas.deferred_shade_fused(
            *(jnp.asarray(d[k]) for k in ("gb_tiles", "z_tiles", "id_tiles", "sh_pack")),
            d["atlases"][0].build(), jnp.asarray(d["active"]), jnp.asarray(d["inv_view"]),
            jnp.asarray(d["cam_pos"]), d["env_ids"], cfg.fov, cfg.ratio, cfg.near, cfg.far,
            W, H, TH, TW, interpret=True, light_dtype=ld)
        out[f"{ld}_{has_env}"] = np.asarray(rt)
        out[f"approx_{ld}_{has_env}"] = np.asarray(approx)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's light_dtype runs for both env cases, from a subprocess started
    when the module's first test asks and read when one needs them (the
    pipeline tests run meanwhile)."""
    path = tmp_path_factory.mktemp("jax_light_dtype") / "runs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false --xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    runs = {}

    def get():
        if not runs:
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log
            runs.update(np.load(path))
        return runs

    try:
        yield get
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _port(has_env, light_dtype, active):
    d = _inputs(5, has_env)
    cfg = d["cfg"]
    rt, approx = shade_fused.deferred_shade_fused(
        *(torch.as_tensor(d[k]) for k in ("gb_tiles", "z_tiles", "id_tiles", "sh_pack")),
        d["atlases"][1].build("cpu"), torch.as_tensor(active), torch.as_tensor(d["inv_view"]),
        torch.as_tensor(d["cam_pos"]), d["env_ids"], cfg.fov, cfg.ratio, cfg.near, cfg.far,
        W, H, TH, TW, light_dtype=light_dtype)
    return rt.numpy(), int(approx)


def _ulps(diff, ref, light_dtype):
    """|diff| in ulps of `light_dtype` at |ref| (at least its smallest
    normal)."""
    t = TORCH_DTYPES[light_dtype]
    r = torch.as_tensor(np.abs(ref)).to(t)
    r = torch.maximum(r, torch.tensor(torch.finfo(t).tiny, dtype=t))
    ulp = torch.nextafter(r, torch.tensor(float("inf"), dtype=t)).double() - r.double()
    return np.abs(diff) / ulp.numpy()


# the pipeline tests come first: they run while the JAX subprocess computes
def test_pipeline_bfloat16_frame_matches_jax_pipeline(jax_runs):
    scene, cam, cfg = _fused_scene(True)
    knobs = dict(FUSED_KNOBS, use_pallas=True, use_tex_kernel=True,
                 fused_light_dtype="bfloat16")
    jp = JaxPipeline(scene, cfg, pallas_interpret=True, **knobs)
    state = jax_state(jp)
    want = np.asarray(jp.render(cam))
    tp = DeferredRenderPipeline(scene, cfg, device="cpu", **knobs)
    assert tp.use_fused_deferred and tp.fused_light_dtype == "bfloat16"
    tp.load_state(state_from_jax(state, "cpu"))
    with recording(shade_fused, "deferred_kernel") as calls:
        got = tp.render(cam).numpy()
    assert [kw["light_dtype"] for _, kw in calls] == ["bfloat16"]
    assert (want.max(-1) > 16).mean() > 0.05
    assert _rmse(got, want) <= RMSE_BAR
    assert dataclasses.asdict(tp.last_stats) == dataclasses.asdict(jp.last_stats)
    f32 = DeferredRenderPipeline(scene, cfg, device="cpu", **dict(knobs, fused_light_dtype=None))
    f32.load_state(state_from_jax(state, "cpu"))
    assert not np.array_equal(f32.render(cam).numpy(), got)


def test_band_frame_keeps_the_float32_light_loop(tmp_path):
    """build_sharded_frame on one gloo rank: kernel D's call takes no
    light_dtype from a pipeline whose fused_light_dtype is bfloat16, and the
    band frame is the float32 pipeline's render() bit for bit."""
    scene, cam, cfg = _fused_scene(True)
    knobs = dict(FUSED_KNOBS, use_pallas=True, use_tex_kernel=True)
    bf16 = DeferredRenderPipeline(scene, cfg, device="cpu", fused_light_dtype="bfloat16",
                                  **knobs)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = frame_sharded.make_mesh(device="cpu")
        with recording(shade_fused, "deferred_kernel") as calls:
            band, _avg = frame_sharded.build_sharded_frame(mesh, bf16)(
                *frame_sharded.frame_args(bf16, cam))
    finally:
        dist.destroy_process_group()
    assert [kw.get("light_dtype") for _, kw in calls] == [None]
    f32 = DeferredRenderPipeline(scene, cfg, device="cpu", **knobs)
    np.testing.assert_array_equal(band.numpy(), f32.render(cam).numpy())


@pytest.mark.parametrize("bad", ["int8", "bf16", "float64"])
def test_other_light_dtypes_raise(bad):
    scene, _, cfg = _fused_scene(False)
    with pytest.raises(ValueError, match="light_dtype"):
        DeferredRenderPipeline(scene, cfg, device="cpu", fused_light_dtype=bad, **FUSED_KNOBS)
    with pytest.raises(ValueError, match="light_dtype"):
        shade_fused.deferred_kernel_reference(*([None] * 9), has_env=False, tile_h=TH,
                                              tile_w=TW, tiles_x=W // TW, light_dtype=bad)


@pytest.mark.parametrize("light_dtype", ["bfloat16", "float16"])
def test_constants_round_to_the_type_as_jax_and_the_kernel_round_them(light_dtype):
    """The light body's Python constants: torch's rounding to the type (the
    plain version), JAX's weak-typed one, and float32 first, then the type
    (the CUDA kernel's `__float2bfloat16_rn(F(c))`), agree."""
    t = TORCH_DTYPES[light_dtype]
    for c in (1.0, 0.0, 1e-6, 1e-20, 3.14159265359, 4.0, 1e-4):
        plain = torch.tensor(c, dtype=t).float().item()
        kernel = torch.tensor(np.float32(c)).to(t).float().item()
        jax_c = float(np.asarray(jnp.asarray(c, jnp.dtype(light_dtype))).astype(np.float32))
        assert plain == kernel == jax_c, c


@pytest.mark.parametrize("has_env", [True, False])
@pytest.mark.parametrize("light_dtype", DTYPES)
def test_plain_light_dtype_matches_jax(jax_runs, light_dtype, has_env):
    runs = jax_runs()
    got, approx = _port(has_env, light_dtype, runs[f"active_{has_env}"])
    want = runs[f"{light_dtype}_{has_env}"]
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    share_bar, ulp_bar = BARS[light_dtype]
    assert np.mean(got == want) >= share_bar
    worst = _ulps(got.astype(np.float64) - want, want, light_dtype).max()
    assert worst <= ulp_bar, worst
    assert approx == int(runs[f"approx_{light_dtype}_{has_env}"])


@pytest.mark.parametrize("has_env", [True, False])
@pytest.mark.parametrize("light_dtype", ["bfloat16", "float16"])
def test_port_computes_the_loop_in_its_type(jax_runs, light_dtype, has_env):
    """Where JAX's run of the type differs from its float32 run, the port's
    run of the type stays within a tenth of that difference (median); the
    port's float32 run does not."""
    runs = jax_runs()
    active = runs[f"active_{has_env}"]
    want, want32 = runs[f"{light_dtype}_{has_env}"], runs[f"float32_{has_env}"]
    moved = want != want32
    assert moved.mean() > 0.2
    step = np.median(np.abs(want - want32)[moved])
    got = _port(has_env, light_dtype, active)[0]
    assert np.median(np.abs(got - want)[moved]) <= 0.1 * step
    got32 = _port(has_env, "float32", active)[0]
    assert np.median(np.abs(got32 - want)[moved]) > 0.1 * step
