"""zultra_tpu_torch — the zultra_tpu DEFLATE encoder ported to PyTorch and
CUDA for one NVIDIA Hopper card (H100).

The device path (match tables, block split, block plans on the device;
framing and the bit splice on the host) writes the same bytes as
zultra_tpu for every container, block size and preset dictionary, in one
shot (``compress``) or through the zlib-style push API (``Stream``,
``compat.ZultraStream``, ``python -m zultra_tpu_torch.cli``). Its stages
run hand-written CUDA kernels (``csrc/``, built with nvcc at first use)
on CUDA tensors and their plain PyTorch versions on CPU tensors; the form
follows the tensor's device, and every entry point takes ``device``
("cuda" unless the caller asks for the CPU) or a list of ``devices``.
``zultra_tpu_torch.parallel`` runs many devices and ``torch.distributed``
processes: corpus statistics, independent members, and one stream
planned across processes (``parallel.multihost``).
"""

from .constants import (
    FLAG_DEFLATE_FRAMING,
    FLAG_GZIP_FRAMING,
    FLAG_ZLIB_FRAMING,
)
from .device_pipeline import DeviceWindowEngine, begin_window_device, compress_device
from .ops import (
    adler32,
    adler32_combine,
    byte_histogram,
    crc32_combine,
    plcp,
    suffix_array,
    token_histogram,
)
from .stream import CONTINUE, FINALIZE, Stream, StreamError, compress, memory_bound

__version__ = "0.1.0"

__all__ = [
    "FLAG_DEFLATE_FRAMING",
    "FLAG_GZIP_FRAMING",
    "FLAG_ZLIB_FRAMING",
    "CONTINUE",
    "FINALIZE",
    "Stream",
    "StreamError",
    "compress",
    "compress_device",
    "memory_bound",
    "DeviceWindowEngine",
    "begin_window_device",
    "suffix_array",
    "plcp",
    "byte_histogram",
    "token_histogram",
    "adler32",
    "adler32_combine",
    "crc32_combine",
    "__version__",
]
