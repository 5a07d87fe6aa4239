"""Host↔device transfer helper.

The reference crosses the host/device boundary explicitly (H2D data copy
src/cudaConvolutionFFT.cu:148, per-kernel D2H :284-286); in JAX transfers are
implicit. ``fetch`` pulls any library output — real maps or complex spectra
such as ``SpectralData.fft`` — to numpy.
"""

from __future__ import annotations

import numpy as np


def fetch(x) -> np.ndarray:
    """Device→host copy of ``x`` as a numpy array."""
    return np.asarray(x)
