"""Multi-process data parallelism of the port (`parallel/distributed.py`),
the counterpart of `gdl_tpu/parallel/`. There is one data group: the
model-parallel mesh of gdl_tpu (`--mp`) is not ported."""
