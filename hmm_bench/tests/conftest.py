def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips on machines without one",
    )
