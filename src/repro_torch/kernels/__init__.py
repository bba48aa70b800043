"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. Modules here import nothing that needs a GPU: the kernels
are built and loaded at first use (`kernels.build`)."""
