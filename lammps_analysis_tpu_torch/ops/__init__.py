"""Device ops: the RDF pair histogram (CUDA kernel + plain torch version)."""
