"""Audio ops: spec helpers, STFT/ISTFT, FFT convolution, the binaural
frontend, and the two CUDA kernels with their plain versions (kernels.py)."""
