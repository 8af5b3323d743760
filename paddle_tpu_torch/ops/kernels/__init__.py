"""Hand-written CUDA kernels for Hopper (sources in ``paddle_tpu_torch/csrc``),
each beside its plain PyTorch version. Counterpart of paddle_tpu's
``ops/pallas/``."""
