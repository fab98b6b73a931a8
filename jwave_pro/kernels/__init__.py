"""Hand-written CUDA kernels, called through jax.ffi (imported lazily
from the ops dispatchers)."""
