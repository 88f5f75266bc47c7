"""repro_torch — the RoCoIn runtime ported to PyTorch and CUDA for NVIDIA
Hopper (H100). The JAX package ``repro`` beside it is the reference; this
package imports nothing of it. Entry points run on the card unless the
caller passes ``device="cpu"``."""
__version__ = "0.1.0"
