"""Host data of the port: synthetic raw batches and the eval preprocessing
that turns a raw batch into model inputs on the device."""
