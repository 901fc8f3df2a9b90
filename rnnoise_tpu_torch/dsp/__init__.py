"""DSP: biquad, transforms, pitch analysis and the spectral CUDA kernels."""
