"""DSP core and the CUDA kernels' wrappers (the JAX package's ``ops`` names).

Importing this package builds no kernel: the wrappers build and load the
kernels at their first launch. It defines the kernels' ``torch.library`` ops
(``torch.ops.sevit.*``), which a saved ``torch.export`` program needs. As in the JAX package, ``ops.stft`` is the
function; import the module as ``ops.stft`` through ``from ..ops.stft import``
or ``importlib``.
"""

from .stft import (  # noqa: F401
    STFTConfig,
    frame_signal,
    griffin_lim,
    istft,
    magphase,
    overlap_add,
    polar,
    reconstruct,
    spectrogram,
    stft,
)
from .resize import resize_bilinear, resize_nearest, upsample_nearest  # noqa: F401
from .windows import get_window, hann  # noqa: F401
from . import (  # noqa: F401
    audio, cuda_attention, cuda_instance_norm, cuda_layer_norm, cuda_scan, cuda_stft, kernels,
)
