"""Tensor ops of the port: audio and image preprocessing, and the window
attention op that dispatches to its CUDA kernel."""
