"""Registers the ``cuda`` marker: tests that need an NVIDIA GPU.  They skip
(through the ``cuda_device`` fixture of the test module) where
``torch.cuda.is_available()`` is false."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is "
        "not available")
