"""zultra_tpu_torch — the zultra_tpu DEFLATE encoder ported to PyTorch and
CUDA for one NVIDIA Hopper card (H100).

The one-shot device path (match tables, block split, block plans on the
device; framing and the bit splice on the host) writes the same bytes as
zultra_tpu for every container, block size and preset dictionary. The
walk, DP and chain stages run hand-written CUDA kernels (``csrc/``,
built with nvcc at first use) on CUDA tensors and their plain PyTorch
versions on CPU tensors; the form follows the tensor's device.
"""

from .device_pipeline import DeviceWindowEngine, compress_device

__version__ = "0.1.0"


def compress(data: bytes, flags: int = 0, max_block_size: int = 0,
             dictionary: bytes | None = None, device="cuda") -> bytes:
    """Compress ``data`` into a deflate (flags 0), zlib (1) or gzip (2)
    stream on ``device``."""
    return compress_device(data, flags, max_block_size, dictionary, device=device)


__all__ = ["compress", "compress_device", "DeviceWindowEngine", "__version__"]
