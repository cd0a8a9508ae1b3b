"""Device ops: the RDF and ADF kernels' wrappers and their plain torch versions."""
