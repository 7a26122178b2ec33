"""The benchmark of the PyTorch and CUDA port `qtos_torch`; see README.md."""
