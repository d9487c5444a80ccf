"""The benchmark of gdl_tpu_torch on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One run is one process: it builds the cell's system from the seed,
warms it up, measures for `--seconds`, checks what the timed path
produced against the plain reference in `portbench/reference/`, and
prints one JSON object as its last line of standard output.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cost sits in a file of its own, found by the name that
`BENCHMARK.json` gives it:

- `configs/<config>.json`: the configuration's sizes and recipe;
- `traffic/<traffic>.json`: the mix's parameters and the driver that
  runs it (`drivers/<driver>.py`);
- `limits/<workload>.json`: the limit of each number that decides
  `correct`, and the readings it was set from;
- `layer_metrics/<metric>.py`: the reader of one per-layer metric;
- `costs/<name>.py`: the operations and bytes of a model or a kernel.

Nothing here imports `jax`, `flax`, `optax` or `gdl_tpu`; the reference
imports nothing of `gdl_tpu_torch` either.
"""
