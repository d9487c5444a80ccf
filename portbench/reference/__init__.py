"""The plain reference: the cells' models, preprocessing and DGL training
step in plain PyTorch, float32 with TF32 off unless asked, written from
the published descriptions and the reference repository's semantics. It
imports nothing of gdl_tpu_torch, gdl_tpu or JAX, and takes nothing the
program made: the harness hands it the seeded weights and raw batches
it hands the program."""
