"""The benchmark of `simple_mmd_renderer_tpu_torch`, the PyTorch and CUDA
renderer, on NVIDIA GPUs.

`python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the repository's `BENCHMARK.json` once and
prints one JSON line. Everything that belongs to one configuration, traffic
mix, per-layer metric or cell lives in a file of its own, found by its name:
`configs/<config>.json`, `traffic/<traffic>.json`, `metrics/<metric>.py`
and `limits/<cell>.json`. The yardstick (inputs, the plain reference, the
metric arithmetic, the peaks) lives here too; from the program the
benchmark takes only the system under test and its pass labels.
"""
