"""Multi-process parallelism of the port, the counterpart of
`gdl_tpu/parallel/`: data parallelism over `torch.distributed`
(`distributed.py`), gdl_tpu's ('data', 'model') mesh of `--mp` as a grid
of groups (`mesh.py`), and the row-parallel layers it splits
(`row_parallel.py`)."""
