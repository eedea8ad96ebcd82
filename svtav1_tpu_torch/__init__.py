"""svtav1_tpu_torch: the PyTorch/CUDA port of the AV1 encoder in svtav1_tpu.

Device work runs as PyTorch tensors on an NVIDIA GPU, with hand-written CUDA
kernels (csrc/, built with nvcc for sm_90a at first use) on the hot path;
host code (entropy coding, bitstream, partition DP, decoder) is the port's
own copy of the reference's numpy/C modules. The entry point is
`svtav1_tpu_torch.pipeline.encoder.Encoder(cfg, device="cuda")`.
"""
