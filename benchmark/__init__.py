"""The benchmark of `direct12pbrrenderer_tpu_torch`, the PyTorch/CUDA port.

One run renders one cell of `BENCHMARK.json` on the card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Configurations (`configs/<name>.json`), traffic mixes (`traffic/<name>.json`)
and per-layer metric readers (`metrics/<name>.py`) are files found by the
names `BENCHMARK.json` gives them. `scenes/` holds frozen copies of the data
generators and `reference/` the plain renderer that decides `correct`.
"""
