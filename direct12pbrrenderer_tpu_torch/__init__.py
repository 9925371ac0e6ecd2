"""direct12pbrrenderer_tpu_torch — the deferred PBR renderer on PyTorch + CUDA.

A port of `direct12pbrrenderer_tpu` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA Hopper GPU. The JAX package stays the reference: this package mirrors
its module layout and public layouts (planes `(24, H, W)`, G-buffer
`(H, W, C)`, active lights `(N, 14)`) so every stage can be compared with its
JAX counterpart on the same inputs.

The host modules it needs are its own copies of the JAX package's, under
the same names and trimmed to what the port uses: `config`,
`graph.frame_graph`, `pipeline.scene_pack`, `scene/`, `resource/` (in-memory
textures and meshes; no loader, serialization or BC codecs), `utils/` and
`tools.stress_scene`. Nothing here imports jax or the JAX package.

Each TPU kernel on the ported path is a hand-written CUDA kernel for sm_90a
(`csrc/`), built at first use by `kernels.build`, with a plain PyTorch
version beside its wrapper that the CPU path and the tests use.
"""

__version__ = "0.1.0"
