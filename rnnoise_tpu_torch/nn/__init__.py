"""NN layers with the reference numerics, and the RNN-step CUDA kernel."""
