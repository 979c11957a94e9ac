"""Plain references the benchmark holds the program to: T5 v1.1 in float32
PyTorch (forward, loss, gradients), AdamWScale, weight-only and KV
quantization. Nothing here imports the program or JAX."""
