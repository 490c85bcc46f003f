"""Public wrappers for the Mamba2 SSD chunk scan."""
from .kernel import ssd_chunk
from .ref import ssd_ref

__all__ = ["ssd_chunk", "ssd_ref"]
