"""The port's deterministic synthetic data pipeline."""
