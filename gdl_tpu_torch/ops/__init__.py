"""Tensor ops of the port: audio and image preprocessing (eval and train
augmentation), and the window attention ops that dispatch to their CUDA
kernels."""
