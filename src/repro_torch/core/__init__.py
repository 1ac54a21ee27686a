"""FFT layer and the serial FNO.

Kept free of imports: ``kernels.spectral_conv.ref`` reuses ``core.dfft``'s
truncate/pad helpers, and ``core.fno`` imports the kernel package, so an
eager import here would be circular.
"""
