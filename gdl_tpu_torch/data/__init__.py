"""Host data of the port: synthetic raw batches and the eval and train
preprocessing that turns a raw batch into model inputs on the device."""
