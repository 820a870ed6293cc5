"""Model stack of the port: layers, decoder stack and serving API."""
