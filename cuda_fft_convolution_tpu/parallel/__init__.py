"""Multi-device layer: device meshes + sharded bank convolution.

Replacement for the reference's experimental multi-GPU path
(src/cudaConvFFTDataStreams.cu): where the reference peer-copies the data FFT
to each GPU (cudaMemcpyPeerAsync :282) and round-robins kernels over
GPU×stream slots (:338-469), here a ``jax.sharding.Mesh`` carries the same
strategy declaratively — data spectrum replicated to every card (XLA hands
the broadcast to NCCL over NVLink), kernel bank sharded — and scales to
several hosts with no code change.
"""

from cuda_fft_convolution_tpu.parallel.mesh import (
    conv_spectral_sharded,
    detect_peaks_sharded,
    make_mesh,
    shard_kernel_bank,
)

__all__ = ["conv_spectral_sharded", "detect_peaks_sharded", "make_mesh", "shard_kernel_bank"]
