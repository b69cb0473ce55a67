"""Optimisers of the port: AdamW and error-feedback gradient compression."""
