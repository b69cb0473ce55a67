def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with CUDA; skips with a reason where there "
        "is none (run on the card with: PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py)",
    )
