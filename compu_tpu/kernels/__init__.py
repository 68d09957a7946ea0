"""Device kernels: JAX/XLA implementations of the codec compute
paths. The numpy modules under ops/ and formats/ are the host oracles for
everything here — same algorithms, same array shapes."""
