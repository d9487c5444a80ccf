"""Models of the port: the Swin encoder, the fusion heads and the
classifier assemblies, named in the reference checkpoint layout."""
