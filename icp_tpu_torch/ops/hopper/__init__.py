"""Hand-written CUDA kernels for Hopper (sm_90a), with the code that builds
and loads them."""
