"""The train step, its state, and the elastic-scaling plans."""
