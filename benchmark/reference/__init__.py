"""The plain reference renderer that decides a run's `correct`.

Plain PyTorch and numpy: it imports neither JAX nor the JAX package nor
anything of the port (`benchmark/tests/test_bench_imports.py` checks it). It
follows the port's plain, all-PyTorch frame (the `use_pallas=False,
use_tex_kernel=False` path: exact atlas and cube samplers, the literal bloom
chain) with the same formulas, so the two agree to rounding; its own
departures, each giving the same result by construction:
* the raster is a depth-min scatter over each triangle's screen AABB
  (ties to the lower triangle id, the fold's "first drawn wins"), not a
  per-tile fold of capped bin lists: no list can overflow here;
* the point lights walk per-cluster lists (each cluster's first 32 hits in
  light order) rather than a per-pixel counter over every light;
* mips, atlas, light rows, IBL products and SH are made here from the
  scene's raw arrays, never taken from the program.
"""
