"""Device operations of the port: the kernel library and the binned-curve update."""
