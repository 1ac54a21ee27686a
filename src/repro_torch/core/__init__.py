"""FFT layer, partitions and the FNO, serial and model-parallel.

Kept free of imports: ``kernels.spectral_conv.ref`` reuses ``core.dfft``'s
truncate/pad helpers, and ``core.fno`` imports the kernel package, so an
eager import here would be circular.
"""
