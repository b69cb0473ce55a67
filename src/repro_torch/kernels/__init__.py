"""Hand-written Hopper kernels of the port, their bindings and plain versions."""
